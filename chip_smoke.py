#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hetmogp_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``hetmogp_tpu_torch/csrc/`` (into
``build/hetmogp_tpu_torch/``) and, phase by phase:

1. checks the RBF kernel, the vector design and the scalar one it
   replaced (kept for ragged shapes), against its plain PyTorch version at
   the main path's shapes, the projected path's and a ragged one, and times
   both in turns with the plain version and an empty kernel at the
   trainer's VE and VM shapes and the serving chunk's;
2. checks the triangular projection kernel (kernel A, float32, TMA-fed)
   against float64 next to cuBLAS (bitwise equal to cuBLAS at M % 4 == 0;
   a ragged M reaches it padded), on random and on the trainer's real
   (Kfu, iLuu), and times it in turns with cuBLAS and the plain version at
   the VE, VM and serving shapes;
3. checks the 3-pass bf16 projection kernel (kernel 3, wgmma and TMA)
   against its plain version and float64 (of the split and of the
   unsplit operands, next to a 1-pass bf16 product) on the same cases,
   and times it in turns with kernel A, cuBLAS and the plain version at
   the same three shapes;
3b. checks kernel 4 (A tril(L) in float32, the mirror of kernel A, with
   quad_diag's square and row sum fused: three epilogues) and kernel 5
   (A tril(L) in three bf16 passes, the mirror of kernel 3) against
   float64 next to cuBLAS and their plain versions, two launches of each
   epilogue bitwise equal, at the VE, VM, serving and adjoint
   (4, 1024, 1024) shapes, a ragged one (padded) and the model's
   (Kfu, iLuu); times them in turns with cuBLAS (and its square and row
   sum for quad_diag), kernel 3 and the plain versions, with bounds; and
   prints the "high" cached adjoints' errors (Lbar, Kbar) against float64
   beside the JAX package's own;
3c. checks kernel 8 (tril(A^T B) with only the lower tiles formed: the
   L gradients of quad_diag and of the cached solve), its float32 FFMA and
   3-pass wgmma designs, against float64 next to their plain versions,
   with exact zeros above the diagonal and two launches bitwise equal, at
   the VE, VM and ragged VM (padded) shapes; times them
   in turns with cuBLAS's dense A^T B and mask, with bounds and the
   schedule's balance; and holds the recursive inverse of the flagship's
   Luu (rec_tri_inverse, on kernels 4 and A) against float64 beside a
   triangular solve's, with its time beside the solve's;
3d. the factorization (``factor_phase``): kernel
   9 (a diagonal panel's Cholesky factor and inverse, one block a matrix)
   against its plain version and float64 in float32 (a panel of the
   flagship's Kuu read through its strides, random panels of 128, 100
   and 9) and float64, exact zeros above the diagonal, NaN for a non-SPD
   panel, two launches bitwise equal; the blocked factorization
   (``blocked_cholesky_inverse``: kernel 9 on its panels, kernels A and 4
   on its products) of the flagship's Kuu and of the ragged M = 777's
   against float64 within twice potrf's and trsm's errors, its launches,
   NaN from the failing panel on, a CUDA graph of it replayed bitwise
   equal to the eager call, its profile (no copy of an operand on the way
   to kernels A and 4); kernel 9 timed in turns with its plain version,
   cholesky_ex and trsm and an empty kernel, and a refresh timed both
   ways (potrf and rec_tri_inverse; the blocked pair), eager and as
   replayed graphs;
4. checks the RBF backward (its autograd.Function) against autograd
   through the plain RBF;
5. trains the flagship model of ``bench.py`` at full width (six
   likelihoods, 1e6 rows, Q=4, M=1024, Dx=2, B=512 a task, float32,
   adam, 4 VE steps per VM step):
   a. the host loop ``make_trainer`` at ``ve_fwd_precision="highest"``:
      ten steps against the plain versions in float32 and float64, the
      kernels' launches in every step, steps/s over three calls of 100
      steps, the ELBO, and a profile of one call;
   b. the main path, as ``bench.py`` configures it: ``make_scan_trainer``
      (one captured CUDA graph per step kind) at ``"high"`` with 1,000
      steps a call.  Ten graphed steps against ten eager steps and the
      plain versions in float32 and float64; a 1,500-step trajectory A/B
      of ``"high"`` against ``"highest"`` from one state and offset
      stream; steps/s over three and five calls of 1,000 steps, for two
      trainers of each precision in turns, with the launches counted from zero
      around each trainer's first call, the final ELBO, peak memory,
      capture time, the host's share of a call and a profile;
6. serves the bench serving model at full width (2 chunks of 65536 rows
   per task) through the kernels, checks what it serves, times it and
   profiles it;
7. runs the rest of the prediction API on the serving model at full
   width: ``predict_latent_u`` and ``predict_f`` with full covariances and
   ``sample_f`` on 4,096 rows, ``predict_f_projected_task`` from a
   2,048-row anchor to 4,096 and 4,095 new rows (the vector and the
   scalar RBF route), ``predictive`` on the solve path and
   ``negative_log_predictive`` with 1,000 samples on 6 x 4,096 rows, each
   against float64 and the plain route, with the launches counted from
   zero around it;
8. serves the same model at 777 inducing points, which the triangular
   products' routers pad to 780 for their TMA designs (and the RBF takes
   its scalar kernel), at both precisions, against the plain versions,
   and differentiates its VM-step loss at "high" and "highest" (kernels 5,
   4 and 8 on padded operands);
9. trains the other ten likelihood families at the flagship's width
   (``families_phase``: Gaussian, Beta, Binomial, Dirichlet, LogNormal,
   Ordinal, NegativeBinomial, StudentT, Weibull, ZeroInflatedPoisson, one
   task each, 1e6 rows, the flagship's trainer at "high" with
   ``learn_lik_params``): ten graphed steps bitwise against eager ones,
   theta included, and against the plain versions in float32 and float64;
   two timed calls of 1,000 steps with the kernels' launches per cycle, a
   profile, and every learned theta finite and moved; then serves the
   trained model (``with_trained_likelihoods``) and scores its NLPD,
   against the plain route and float64, and evaluates its ELBO on a
   minibatch without a gradient (kernel 6's value-alone launch of the
   task table: Beta, Binomial, Dirichlet and the ZIP are in it, and the
   likelihood term's program counters read 4 table and 6 engine tasks);
10. trains with the other optimizers and loops at the flagship's width
   (``optimizers_phase``): ``examples/large_scale.py --natgrad`` (natural
   gradients, both retractions) through the graphed trainer, against
   eager, plain float32 and float64, timed, with its backoff codes and a
   profile; Adadelta with its lookahead, adam with a warmup-cosine
   schedule and clipping, adam on the gather sampler and joint-mode
   natural gradients, ten graphed steps each against eager and a rising
   ELBO; batch VEM by L-BFGS; ``svi_fit`` of the un-whitened model on the
   solve path over a ``MinibatchStream``;
11. walks the user's lifecycle at the flagship's width
   (``lifecycle_phase``, the launches counted from 0 around it): an
   ``SVMOGP`` trained for 200 graphed steps with checkpoints every 50,
   a run cut at 100 and resumed to 200 (params and ELBOs bitwise equal to
   the uninterrupted run, the kept ``step_`` directories), the checkpoint's
   size and save and load times; ``save``/``load`` with equal full-data
   ELBOs; ``export_serving_predictive`` of 65,536 rows loaded and run
   (bitwise equal to ``make_serving_predictive``, the same launches, the
   ``hetmogp::`` nodes, rows/s of both in turns); ``export_predictive`` of
   six tasks against the eager ``predictive``; the rank-2 flagship (8
   latent copies: ten graphed steps bitwise against eager and within the
   plain bounds, the kernels launched at batch 8, steps/s); and
   ``chol_dtype="float64"`` against ``"same"`` (steps/s in turns, the
   ELBO difference);
12. splits the flagship at ``"high"`` over ranks (``parallel_phase``):
   a. four gloo ranks of a (2, 2) ``("data", "latent")`` mesh sharing
      the card (``parallel.spawn_local``; the collectives go through the
      host, so the steps run eagerly): ten sharded steps against ten
      unsharded eager steps of the same state and offsets (within the
      plain f32 bounds of 5b), each rank's launches and the shapes it
      launched the kernels at (batch 2 on 1,536 rows, and 384 in the VM
      step), steps/s of a 100-step call, a sharded checkpoint at step 50
      and a run cut there and resumed to 100 (bitwise the uninterrupted
      sharded run), and ``predictive_sharded`` of 6 x 65,536 rows
      against ``make_serving_predictive``;
   b. a world-1 NCCL ``("data",)`` mesh in this process: the graphed
      trainer with its collectives captured, ten steps bitwise equal to
      the unsharded ``make_scan_trainer``, and steps/s of both in turns
      over calls of 1,000 steps.

13. checks kernel 6 per engine, the one-pass Gauss-Hermite sweep (value,
   E[d1] and E[d2] in one launch) of the flagship's Bernoulli,
   Categorical(K=3) and Gamma lngamma engines, against the plain autograd
   engine at the VE (512 rows), VM (128) and fused (3,072) row counts in
   float32 and float64, extreme moments included, with its value-only
   launcher, and times it beside the plain engine and an empty kernel;
   kernel 6's task table, the ELBO's likelihood term of the six tasks in
   one launch and its gradient in one more, against the plain term (the
   sums, the rows' values and coefficients, dM and dV) at 6 x 512,
   6 x 128, 6 x 3,072 and a ragged, padded table in float32 and float64,
   random and extreme rows, the value alone bitwise the derivative
   launch's and two launches bitwise equal, and times it in turns with
   the per-engine path and the plain term, eager and graphed; the same
   for the ten-family model's table (Beta, Binomial n = 10, Dirichlet
   K = 3, the ZIP: several sweeps a row, the instantiations that compile
   them in) at 4 x 512 and 4 x 128 (``task_check_phase``,
   ``task_time_phase``); kernel 7, the masked adam
   update of every leaf in one launch, bitwise against ``train._adam`` in
   a VE and a VM step with a float and a schedule's tensor rate, in
   float32 and float64, timed beside ``_adam`` and ``torch._fused_adam_``
   (``sweep_phase``); and profiles ten eager flagship steps with every
   kernel attributed to the op that launched it, grouped into the
   likelihood term, the adam update and the rest, with the term on the
   plain versions, on the per-engine path and on the task table
   (``op_profile_phase``).

They run in the order 1, 4, 6, 7, 8, 5a, 2, 3, 3b, 3c, 3d, 13 (the kernels), 5b,
13 (the op profile), 9, 10, 11, 12.
The serving pass is the process's first profiled call: as its sixth,
after the trainers', the profiler lost one of its twelve requests'
records (and a prediction is then the first to ask for each quadrature
grid, as in a process that serves before it trains).  A trainer's profile
that lost records is taken again (``profile_replays``).  Phases 2, 3 and
3b take the model's (Kfu, Luu, iLuu) from 5a, and 3c its Luu.

Every phase raises on failure, so any failure exits non-zero; so does a
machine without CUDA.  The line before the last is the kernel table as
JSON (every kernel launcher, each route included, and the ten-family
table's instantiations of kernel 6; the per-engine sweeps, on no main
path, with 0 launches and ``"main_path": false``); the last line is
``{"ok": true, "device": {...}}``.  About eight minutes on one H100.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import json
import os
import re
import shutil
import statistics
import sys
import time

import numpy as np
import torch

from hetmogp_tpu_torch.profiling import (BF16_PEAK, F32_PEAK,
                                         HBM_BYTES_PER_S, bound_ms, card,
                                         device_times_ms, sampled_clocks)

SEED = 0
CHUNK = 65536  # rows per serving request (the bench's chunk)
N_CHUNKS = 2  # per task: the bench's 1e6 rows over 6 tasks, in whole chunks
Q, M, DX = 4, 1024, 2
ACC_ROWS = 4096  # rows of the chunk checked against the plain and f64 runs
KERNEL_ATOL = 2e-6  # the JAX package's own kernel tolerance
# The f32 serving path with the kernel against the same path with the plain
# RBF, normwise (max |a - b| / max |b| per output): the two differ only in
# Kfu's rounding (checked to 2e-6 above), which the projection through
# iLuu (entries of order 1e2 at jitter 1e-4) amplifies.
PLAIN_F32_BOUND = 1e-3
# Against float64: the f32 projection P = Kfu iLuu^T holds about 2.3e-4
# relative (the JAX package's measurement at this M and conditioning), and
# the variance kdiag + quad - |P|^2 cancels about one more digit.
F64_BOUND = 1e-2
# The triangular projection kernel against a float64 product of the same
# float32 inputs, normwise: at most this multiple of cuBLAS's own error.
# Both sum at most M float32 products with float32 accumulation; a
# different summation order changes the rounding by a small factor, while
# a wrong mask, a skipped block or a missing term gives an error of order
# one.
PROJ_VS_CUBLAS = 4.0
# The RBF backward (kernel forward + rbf_K_batched_bwd) against autograd
# through the plain RBF, normwise per cotangent: in float32 both reduce
# 3072 x 1024 terms per (q, d) in different orders (~sqrt(n) eps ~ 1e-5);
# in float64 the same algebra in another order.
RBF_BWD_F32 = 1e-4
RBF_BWD_F64 = 1e-10
# The trainer with the kernels against the same ten steps with the plain
# versions in float32, relative ELBO difference per step.  Up to the first
# VM step (whose ELBO comes before its update) only q(u) has moved: the
# runs differ by Kfu's rounding (<= 2e-6 absolute) and the projection's
# summation order, amplified through iLuu (entries ~1e2), which moves the
# served moments by up to ~2e-4 normwise (the serving phase below); the
# ELBO sums 3072 rows' terms whose errors partly cancel: 1e-5.  After it,
# adam has moved every hyper and Z entry by about half the step rate in the
# sign of its gradient, and entries whose gradient is below float32 noise
# move either way between the two runs, so the models differ by such
# moves: 3e-4, the size of the float32-to-float64 gap below.
TRAIN_PLAIN_F32_VE = 1e-5
TRAIN_PLAIN_F32 = 3e-4
# Against float64 (plain versions, same inputs and offsets): the float32
# projection holds ~2.3e-4 relative and the variance cancels a digit more
# (the served moments' worst error against float64 is ~1.5e-3); summed
# over rows, 2e-3.
TRAIN_F64 = 2e-3
TRAIN_N_PER = 1_000_000 // 6  # bench.py:84-86
TRAIN_B = 512
HOST_CALL_STEPS, HOST_CALLS = 100, 3  # the host loop
GRAPH_CALL_STEPS, GRAPH_CALLS = 1000, 5  # bench.py:233-235, :84-86
PROFILE_STEPS = 50
# traces of one call that profile_replays takes until one holds every
# hand kernel's calls
PROFILE_TRIES = 4
# Kernel 3 against the float64 product of the split operands, normwise: at
# most this multiple of the plain version's error against the same
# reference.  The plain version sums exact bf16 products in float32 with
# cuBLAS; the tensor cores sum each 16-deep step's products at their own
# internal precision before the float32 add, a few times rounder.  A lost
# or doubled term is off by the size of the lo products, ~2^-8 of |P|.
PROJ3_VS_PLAIN = 16.0
# Kernel 3 against the float64 product of the unsplit operands: at most
# this share of a 1-pass bf16 product's error (both operands rounded to
# bf16, float32 accumulation).  The 3-pass error is ~2^-14 relative per
# product and the 1-pass one ~2^-8: without its lo terms kernel 3 would
# match the 1-pass error.
PROJ3_VS_ONE_PASS = 1.0 / 16.0
# Ten graphed steps against ten eager steps of the same step body on the
# same offsets: the graph replays the kernels that the eager steps launch,
# on the same inputs, so the two agree to the last bit unless a library
# picks another algorithm under capture: 1e-6 relative ELBO.
GRAPH_VS_EAGER = 1e-6
# The graphed "high" steps against the plain versions ("high" is then the
# plain 3-pass product of the same split) in float32, relative ELBO.  Up
# to the first VM step the two differ by Kfu's rounding and by kernel 3's
# summation order.  On the model's own (Kfu, iLuu) the cancelling products
# of iLuu (entries ~1e2) make that order matter: kernel 3 and the plain
# version differ by ~3e-4 of max|P| there (phase 3 prints it), and the
# ELBO moves by about as much through the variance cancellation: 1e-3.
# After it, as for the host loop, adam's sign-sized moves of hypers whose
# gradients sit at float32 noise: 2e-3.
GRAPH_PLAIN_F32_VE = 1e-3
GRAPH_PLAIN_F32 = 2e-3
# Against float64 (plain, full precision): the 3-pass P is ~2^-14
# relative per product where full float32 is ~2^-24; the JAX package
# measured 6.3e-3 relative in P at "high" on these shapes against 2.3e-4
# at "highest", and an absolute variance error ~5e-3, below quadrature
# noise.  Summed over rows, 5e-3.
GRAPH_F64 = 5e-3
# The 1,500-step trajectories at "high" and "highest" from one state and
# one offset stream: per-100-step mean ELBOs within 2e-3 relative, the
# JAX package's adoption criterion (docs/DESIGN.md:387-393).
AB_STEPS, AB_EVERY, AB_TOL = 1500, 100, 2e-3
# The padded path: serving a model of 777 inducing points, a depth whose
# rows TMA cannot address (M % 4 != 0), so the triangular products' routers
# pad it to 780 (ops/cuda_kernels.py::_tma_operands).  At "high" its moments
# against the plain 3-pass path differ by kernel 3's summation order, which
# moves P by ~3e-4 of max|P| on a model's own (Kfu, iLuu) (phase 3), and
# the variance's cancellation kdiag + quad - |P|^2 loses about a digit
# more: 1e-2.  A lost lo term moves P by ~2^-8 of it, ten times that.
RAGGED_M = 777
RAGGED_HIGH_BOUND = 1e-2


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmuls must run at 'highest' precision: "
                           "TF32 ruins the projection P = Kfu iLuu^T")
    smi = card()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()} [card: {smi}]")
    return smi


def build_phase(smi: str):
    from hetmogp_tpu_torch.ops import _build, cuda_kernels

    t0 = time.perf_counter()
    path = _build.build()
    cuda_kernels.load()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s"
          f" [card: {smi}]")
    # ptxas -v: each kernel's spills, registers and shared memory (the
    # dynamic shared memory of the TMA kernels is set at launch: csrc/*.cu
    # SMEM_BYTES)
    for kernel, line in _build.ptxas_lines(
            path.with_suffix(".log").read_text()):
        print(f"  ptxas, {kernel}: {line} [card: {smi}]")


# the RBF kernel's timed shapes: the VE step's Kfu (6 x 512 rows), the VM
# step's (a quarter of them), a serving chunk's
RBF_SHAPES = {"training": 6 * TRAIN_B, "VM": 6 * TRAIN_B // 4,
              "serving": CHUNK}
PROJECTED_ANCHOR, PROJECTED_NS = 2048, 4096  # the projected path's Kx


def kernel_phase(smi: str) -> list:
    """The RBF kernel, both routes, against its plain version, and their
    times in turns with the plain version and an empty kernel."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    plain = ck.rbf_K_batched_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(q, n, m, dx, iso):
        def u(*shape):
            return torch.rand(*shape, generator=gen, device="cuda")
        return (u(n, dx), u(q, m, dx), 0.2 + 0.1 * u(q, 1 if iso else dx),
                0.5 + u(q))

    proj = f"(4, {PROJECTED_ANCHOR}, "
    # the main path's three shapes (on an H100's 132 SMs a block of the
    # vector kernel gets 24 rows at the VE shape: the unrolled loop only; 6
    # at the VM shape: the tail loop only; 497 at the serving shape: both),
    # then the other routes'
    cases = {f"{name} (4, {rows}, 1024, Dx=2, ARD)": (Q, rows, M, DX, False)
             for name, rows in RBF_SHAPES.items()}
    cases.update({
        "isotropic (4, 5000, 1000, Dx=3)": (4, 5000, 1000, 3, True),
        "ragged (3, 13, 7, Dx=1)": (3, 13, 7, 1, False),
        f"projected {proj}{PROJECTED_NS}, Dx=2)":
            (Q, PROJECTED_ANCHOR, PROJECTED_NS, DX, False),
        f"projected, odd Ns {proj}{PROJECTED_NS - 1}, Dx=2)":
            (Q, PROJECTED_ANCHOR, PROJECTED_NS - 1, DX, False)})
    errs = {"vec": {}, "scalar": {}}
    for name, shape in cases.items():
        args = inputs(*shape)
        want = plain(*args)
        routed = ck.rbf_route(shape[2], shape[3])
        # the scalar kernel takes every shape; the vector kernel its own
        kernels = {"scalar": ck.rbf_K_batched_scalar}
        if routed == "vec":
            kernels["vec"] = ck.rbf_K_batched_vec
        before = ck.launch_counts()
        via_router = ck.rbf_K_batched(*args)
        took = {k: v - before[k] for k, v in ck.launch_counts().items() if
                v != before[k]}
        if took != {f"rbf_K_batched_{routed}": 1}:
            raise AssertionError(f"{name}: routed to {took}, not {routed}")
        for route, kern in kernels.items():
            got = kern(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs[route][name] = err
            same = bool(torch.equal(got, via_router))
            print(f"rbf kernel ({route}) vs plain, {name}: max_abs_err "
                  f"{err:.3e} (atol {KERNEL_ATOL:g}); the router takes "
                  f"{routed}; bitwise equal to the routed kernel {same} "
                  f"[card: {smi}]")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"rbf kernel ({route}) disagrees with "
                                     f"plain: {name}")
            # one reciprocal, one sum order: the routes agree to the bit
            if not same:
                raise AssertionError(f"rbf routes disagree: {name}")
        del want, via_router, got
    # what any launch costs on the device: the floor under the small shapes
    floor = statistics.median(device_times_ms(ck.empty_launch, reps=40))
    print(f"empty kernel: {floor:.4f} ms, median of 40 launches behind the "
          f"device sleep [card: {smi}]")
    times = {}
    for name, rows in RBF_SHAPES.items():
        args = inputs(Q, rows, M, DX, False)
        t, n = time_in_turns({"plain": plain,
                              "scalar": ck.rbf_K_batched_scalar,
                              "vec": ck.rbf_K_batched_vec}, *args)
        out_bytes = Q * rows * M * 4
        # each input read once, the output written once; exp and ~3 Dx + 2
        # float32 operations per output element
        nbytes = sum(a.numel() * 4 for a in args) + out_bytes
        bound = bound_ms(nbytes, Q * rows * M * (3 * DX + 3), F32_PEAK)
        times[name] = t, bound
        new, old = t["vec"], t["scalar"]
        print(f"rbf kernel time, {name} (4, {rows}, 1024): vec {new:.4f} ms "
              f"({out_bytes / (new * 1e-3) / 1e12:.3f} TB/s of output, "
              f"{bound[0] / new * 100:.1f}% of the bound), first design "
              f"(scalar) {old:.4f} ms ({out_bytes / (old * 1e-3) / 1e12:.3f} "
              f"TB/s, {bound[0] / old * 100:.1f}%), plain {t['plain']:.4f} "
              f"ms; bound {bound[0]:.4f} ms ({bound[1]}); empty kernel "
              f"{floor:.4f} ms; no single PyTorch call computes it; median "
              f"of {n} calls each [card: {smi}]")
    # the entry's time and its error are of one shape: the VE step's
    t, bound = times["training"]
    training = f"training (4, {RBF_SHAPES['training']}, 1024, Dx=2, ARD)"
    return [{"name": f"rbf_K_batched_{route}", "route": "cuda",
             "source": "hetmogp_tpu_torch/csrc/rbf_kernel.cu",
             "replaces": "hetmogp_tpu/ops/pallas_kernels.py:43",
             "max_abs_err": errs[route][training], "ms": t[route],
             "plain_ms": t["plain"], "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None}
            for route in ("vec", "scalar")]


def random_projection_case(gen, q, n, m):
    """A (q, n, m) and a well-conditioned lower-triangular L (q, m, m),
    standard normal, from ``gen``."""
    A = torch.randn(q, n, m, generator=gen, device="cuda")
    L = (torch.tril(torch.randn(q, m, m, generator=gen, device="cuda"))
         / m ** 0.5 + 2.0 * torch.eye(m, device="cuda"))
    return A, L


# the projection's timed shapes: the VE step's P, the VM step's, a serving
# chunk's
PROJ_SHAPES = {"training (4, 3072, 1024)": (Q, 6 * TRAIN_B, M),
               "VM (4, 768, 1024)": (Q, 6 * TRAIN_B // 4, M),
               "serving (4, 65536, 1024)": (Q, CHUNK, M)}


def time_in_turns(fns: dict, *args):
    """Median device ms of each of ``fns`` on ``args``, timed in turns
    there and back (the order of ``fns``, then reversed)."""
    samples = {k: [] for k in fns}
    order = list(fns.items())
    for k, f in order + order[::-1]:
        samples[k] += device_times_ms(lambda f=f: f(*args))
    return ({k: statistics.median(v) for k, v in samples.items()},
            len(samples[order[0][0]]))


def proj_entry(name, source, replaces, err, t, yardstick, plain, bound):
    return {"name": name, "route": "cuda",
            "source": f"hetmogp_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": t[yardstick],
            "plain_ms": t[plain], "bound_ms": bound[0], "bound_by": bound[1]}


def projection_phase(smi: str, Kfu: torch.Tensor,
                     iLuu: torch.Tensor) -> list:
    """Kernel A (a ragged M padded by its router) against a float64
    product next to cuBLAS, and its times in turns with cuBLAS and the
    plain version."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {"training (4, 3072, 1024)": random_projection_case(gen, Q, 3072,
                                                                M),
             "serving (4, 65536, 1024)": random_projection_case(gen, Q, CHUNK,
                                                                M),
             "ragged (3, 1000, 777)": random_projection_case(gen, 3, 1000,
                                                             777),
             "training Kfu, iLuu of the model": (Kfu, iLuu)}
    errs = {}
    for name, (A, L) in cases.items():
        cub = A @ torch.tril(L).mT
        ref = A.double() @ torch.tril(L).double().mT
        scale = ref.abs().max()
        ec = float((cub.double() - ref).abs().max() / scale)
        aligned = A.shape[-1] % 4 == 0
        before = ck.tril_projection_tma.launches
        got = ck.tril_projection(A, L)
        ek = float((got.double() - ref).abs().max() / scale)
        bitwise = bool(torch.equal(got, cub))
        errs[name] = float((got - cub).abs().max())
        print(f"projection kernel, {name}: normwise error vs f64 {ek:.3e}, "
              f"plain version (cuBLAS) {ec:.3e} (bound {PROJ_VS_CUBLAS:g}x "
              f"plain); max abs difference from plain {errs[name]:.3e}, "
              f"bitwise equal {bitwise}"
              f"{' (required: aligned shape)' if aligned else ' (padded)'}"
              f" [card: {smi}]")
        if not (ek <= PROJ_VS_CUBLAS * ec
                and ck.tril_projection_tma.launches == before + 1):
            raise AssertionError(f"projection kernel error {ek} > "
                                 f"{PROJ_VS_CUBLAS} x cuBLAS {ec}, or not "
                                 f"one launch of its TMA design: {name}")
        # one float32 FMA chain per output in increasing m, as cuBLAS
        # sums: the host loop's TRAIN_PLAIN_F32_VE rests on it
        if aligned and not bitwise:
            raise AssertionError(f"projection kernel not bitwise equal to "
                                 f"cuBLAS: {name}")
        del got
        del cub, ref
    del cases
    times = {}
    for name, shape in PROJ_SHAPES.items():
        A, L = random_projection_case(gen, *shape)
        Lt = torch.tril(L)
        t, n = time_in_turns({"plain": ck.tril_projection_plain,
                              "kernel A (tma)": ck.tril_projection_tma,
                              "cuBLAS": lambda a, _: a @ Lt.mT}, A, L)
        bound = proj_bound(A, L, 1, F32_PEAK)
        times[name] = t, bound
        q, n_, m = A.shape
        flop = q * n_ * m * (m + 1)  # the triangular FLOPs
        new = t["kernel A (tma)"]
        print(f"projection time, {name}: kernel A (tma) {new:.4f} ms "
              f"({flop / new / 1e9:.2f} TFLOP/s, {bound[0] / new * 100:.1f}% "
              f"of the bound), cuBLAS {t['cuBLAS']:.4f} ms, plain version {t['plain']:.4f} ms; "
              f"bound {bound[0]:.4f} ms ({bound[1]}, float32 at "
              f"{F32_PEAK / 1e12:g} TFLOP/s); TFLOP/s on Q*N*M*(M+1) = "
              f"{flop:.3e}; median of {n} calls each [card: {smi}]")
        del A, L, Lt
    t, bound = times["training (4, 3072, 1024)"]
    model = "training Kfu, iLuu of the model"
    return [dict(proj_entry("tril_projection_tma", "tril_proj_kernel.cu",
                            "tools/probe_pallas_proj.py:20", errs[model], t,
                            "kernel A (tma)", "plain", bound),
                 library_ms=t["cuBLAS"])]


def proj_bound(A, L, passes: int, peak: float):
    """Bound of A tril(L)^T: A, L read once, out written once; `passes`
    products of the Q N M (M + 1) triangular FLOPs."""
    q, n, m = A.shape
    nbytes = 4 * (2 * A.numel() + L.numel())
    return bound_ms(nbytes, passes * q * n * m * (m + 1), peak)


def projection3_phase(smi: str, Kfu: torch.Tensor,
                      iLuu: torch.Tensor) -> list:
    """Kernel 3 (a ragged M padded by its router) against its plain
    version and float64 (of the split and of the unsplit operands), and
    its times in turns with kernel A, cuBLAS float32 and the plain
    version."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    plain = ck.tril_projection_3pass_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = {"training (4, 3072, 1024)": random_projection_case(gen, Q, 3072,
                                                                M),
             "serving (4, 65536, 1024)": random_projection_case(gen, Q, CHUNK,
                                                                M),
             "ragged (3, 1000, 777)": random_projection_case(gen, 3, 1000,
                                                             777),
             "training Kfu, iLuu of the model": (Kfu, iLuu)}
    errs = {}
    for name, (A, L) in cases.items():
        want = plain(A, L)
        ahi, alo = ck.split_bf16(A)
        lhi, llo = (t.double() for t in ck.split_bf16(torch.tril(L)))
        ahi, alo = ahi.double(), alo.double()
        ref_split = (alo @ lhi.mT + ahi @ llo.mT) + ahi @ lhi.mT
        del ahi, alo, lhi, llo
        ref = A.double() @ torch.tril(L).double().mT
        one = (A.to(torch.bfloat16).float()
               @ torch.tril(L).to(torch.bfloat16).float().mT)
        e_p, f_p, f_1 = (normwise(want, ref_split), normwise(want, ref),
                         normwise(one, ref))
        before = ck.tril_projection_3pass_tma.launches
        got = ck.tril_projection_3pass(A, L)
        e_k, f_k = normwise(got, ref_split), normwise(got, ref)
        errs[name] = float((got - want).abs().max())
        print(f"3-pass kernel, {name}: normwise error vs f64 of the split "
              f"operands {e_k:.3e}, plain version {e_p:.3e} (bound "
              f"{PROJ3_VS_PLAIN:g}x plain); vs f64 of the unsplit operands "
              f"{f_k:.3e}, plain {f_p:.3e}, 1-pass bf16 {f_1:.3e} (bound "
              f"{PROJ3_VS_ONE_PASS:g}x 1-pass); max abs difference from "
              f"plain {errs[name]:.3e} [card: {smi}]")
        if not (e_k <= PROJ3_VS_PLAIN * e_p
                and f_k <= PROJ3_VS_ONE_PASS * f_1
                and ck.tril_projection_3pass_tma.launches == before + 1):
            raise AssertionError(f"3-pass kernel out of bounds, or not one "
                                 f"launch of its TMA design: {name}")
        del got
        del want, ref_split, ref, one
    del cases
    times = {}
    for name, shape in PROJ_SHAPES.items():
        A, L = random_projection_case(gen, *shape)
        Lt = torch.tril(L)
        t, n = time_in_turns({"plain": plain,
                              "kernel 3 (tma)": ck.tril_projection_3pass_tma,
                              "kernel A (tma)": ck.tril_projection_tma,
                              "cuBLAS f32": lambda a, _: a @ Lt.mT}, A, L)
        bound = proj_bound(A, L, 3, BF16_PEAK)
        times[name] = t, bound
        new = t["kernel 3 (tma)"]
        print(f"3-pass projection time, {name}: kernel 3 (tma) {new:.4f} ms "
              f"({bound[0] / new * 100:.1f}% of the bound), kernel A (tma) "
              f"{t['kernel A (tma)']:.4f} ms, cuBLAS f32 "
              f"{t['cuBLAS f32']:.4f} ms, plain version {t['plain']:.4f} ms; "
              f"bound {bound[0]:.4f} ms ({bound[1]}, bf16); no PyTorch call "
              f"computes the 3-pass product; median of {n} calls each "
              f"[card: {smi}]")
        del A, L, Lt
    t, bound = times["training (4, 3072, 1024)"]
    model = "training Kfu, iLuu of the model"
    return [dict(proj_entry("tril_projection_3pass_tma",
                            "tril_proj3_kernel.cu",
                            "tools/probe_pallas_proj.py:110", errs[model], t,
                            "kernel 3 (tma)", "plain", bound),
                 library_ms=None)]


# Kernel 4's row sums of squares against the float64 row sums: r = sum_k
# out_k^2 moves by about twice out's relative error, which holds
# PROJ_VS_CUBLAS times cuBLAS's (above); a lost tile or a wrong mask is
# off by a share of order one.
QUAD_VS_CUBLAS = 2.0 * PROJ_VS_CUBLAS
# The "high" cached adjoints against float64 on the card, normwise: twice
# what the JAX package measured on its chip at Precision.HIGH
# (hetmogp_tpu/ops/linalg.py:182-186): Lbar ~5e-3, Kbar ~3e-5.
JAX_HIGH_LBAR, JAX_HIGH_KBAR = 5e-3, 3e-5
# the products' shapes: the VE step's quad_diag(P, Lq), the VM step's, a
# serving chunk's, and the adjoints' (M, M) products
RIGHT_SHAPES = {**PROJ_SHAPES, "adjoint (4, 1024, 1024)": (Q, M, M)}
RAGGED_RIGHT = (3, 1000, RAGGED_M)


def right_bound(A, L, passes: int, peak: float, epilogue="product"):
    """Bound of A tril(L): A and L read once, out (or the row sums)
    written once; ``passes`` products of the Q N M (M + 1) triangular
    FLOPs."""
    q, n, m = A.shape
    out = A.numel() if epilogue == "product" else q * n
    return bound_ms(4 * (A.numel() + L.numel() + out),
                    passes * q * n * m * (m + 1), peak)


def right_products_phase(smi: str, Kfu: torch.Tensor, Luu: torch.Tensor,
                         iLuu: torch.Tensor) -> list:
    """Kernel 4 (A tril(L) in float32, with quad_diag's row sum fused) and
    kernel 5 (the same product in three bf16 passes), through their
    routers (a ragged M padded): every epilogue against its plain version
    and float64, kernel 4's product bitwise cuBLAS's at M % 4 == 0, two
    launches bitwise equal, each call one launch of its TMA design,
    times of the three epilogues in turns with cuBLAS and the plain
    versions at the VE, VM, serving and adjoint shapes (TFLOP/s, share of
    the bound, clocks.sm sampled beside); then the "high" cached adjoints'
    errors against float64, beside the JAX package's."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import linalg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = {name: random_projection_case(gen, *shape)
             for name, shape in RIGHT_SHAPES.items()}
    cases["ragged (3, 1000, 777)"] = random_projection_case(gen,
                                                            *RAGGED_RIGHT)
    cases["training Kfu, iLuu of the model"] = (Kfu, iLuu)
    errs = {}
    for name, (A, L) in cases.items():
        Lt = torch.tril(L)
        cub = A @ Lt
        ref = A.double() @ Lt.double()
        ref_r = torch.sum(torch.square(ref), dim=-1)
        ec = normwise(cub, ref)
        ahi, alo = (t.double() for t in ck.split_bf16(A))
        lhi, llo = (t.double() for t in ck.split_bf16(Lt))
        ref_split = (alo @ lhi + ahi @ llo) + ahi @ lhi
        del ahi, alo, lhi, llo
        plain3 = ck.matmul_tril_3pass_plain(A, L)
        one = A.to(torch.bfloat16).float() @ Lt.to(torch.bfloat16).float()
        e_p, f_1 = normwise(plain3, ref_split), normwise(one, ref)
        del one
        aligned = A.shape[-1] % 4 == 0
        ck.zero_launch_counts()
        out, again = ck.tril_right(A, L), ck.tril_right(A, L)
        both, r = ck.tril_right(A, L, "both")
        rs, rs_again = ck.tril_right(A, L, "rowsum"), ck.tril_right(A, L,
                                                                    "rowsum")
        ek, er = normwise(out, ref), normwise(rs, ref_r)
        same = (torch.equal(out, again) and torch.equal(rs, rs_again)
                and torch.equal(both, out) and torch.equal(r, rs))
        errs["k4", name] = float((out - cub).abs().max())
        print(f"kernel 4{'' if aligned else ' (padded)'}, {name}: normwise "
              f"error vs f64 {ek:.3e}, cuBLAS {ec:.3e} (bound "
              f"{PROJ_VS_CUBLAS:g}x cuBLAS); row sums of squares vs f64 "
              f"{er:.3e} (bound {QUAD_VS_CUBLAS:g}x cuBLAS); max abs "
              f"difference from cuBLAS {errs['k4', name]:.3e}, bitwise "
              f"equal to cuBLAS {torch.equal(out, cub)}; two launches of "
              f"each epilogue bitwise equal, and \"both\" bitwise the other "
              f"two: {same} [card: {smi}]")
        if not (ek <= PROJ_VS_CUBLAS * ec and er <= QUAD_VS_CUBLAS * ec
                and same and ck.tril_right_tma.launches == 5):
            raise AssertionError(f"kernel 4 out of bounds, not "
                                 f"deterministic, or not five launches of "
                                 f"its TMA design: {name}")
        # each output one float32 FMA chain over increasing m, as
        # cuBLAS's: at M % 4 == 0 (every shape here but the ragged one)
        # the product is cuBLAS's to the bit, as it was before this design
        if aligned and not torch.equal(out, cub):
            raise AssertionError(f"kernel 4 is not bitwise cuBLAS's "
                                 f"A @ tril(L): {name}")
        del out, again, both, r, rs, rs_again
        got, again = ck.tril_right3(A, L), ck.tril_right3(A, L)
        e_k, f_k = normwise(got, ref_split), normwise(got, ref)
        errs["k5", name] = float((got - plain3).abs().max())
        print(f"kernel 5{'' if aligned else ' (padded)'}, {name}: normwise "
              f"error vs f64 of the split operands {e_k:.3e}, plain version "
              f"{e_p:.3e} (bound {PROJ3_VS_PLAIN:g}x plain); vs f64 of the "
              f"unsplit operands {f_k:.3e}, 1-pass bf16 {f_1:.3e} (bound "
              f"{PROJ3_VS_ONE_PASS:g}x 1-pass); max abs difference from "
              f"plain {errs['k5', name]:.3e}; two launches bitwise equal "
              f"{torch.equal(got, again)} [card: {smi}]")
        if not (e_k <= PROJ3_VS_PLAIN * e_p
                and f_k <= PROJ3_VS_ONE_PASS * f_1
                and torch.equal(got, again)
                and ck.tril_right3_tma.launches == 2):
            raise AssertionError(f"kernel 5 out of bounds, not "
                                 f"deterministic, or not two launches of "
                                 f"its TMA design: {name}")
        del got, again
        del cub, ref, ref_r, ref_split, plain3
    del cases
    torch.cuda.empty_cache()

    times = {}
    for name, shape in RIGHT_SHAPES.items():
        A, L = random_projection_case(gen, *shape)
        Lt = torch.tril(L)
        t, n = time_in_turns({
            "plain": ck.matmul_tril_plain,
            "kernel 4 (tma)": ck.tril_right_tma,
            "cuBLAS": lambda a, _: a @ Lt}, A, L)
        tq, _ = time_in_turns({
            "plain": ck.quad_diag_plain,
            "kernel 4 (tma, rowsum)": lambda a, l: ck.tril_right_tma(
                a, l, "rowsum"),
            "kernel 4 (tma, both)": lambda a, l: ck.tril_right_tma(a, l,
                                                                   "both"),
            "cuBLAS, square, sum": lambda a, _: torch.sum(
                torch.square(a @ Lt), dim=-1)}, A, L)
        t3, _ = time_in_turns({
            "plain": ck.matmul_tril_3pass_plain,
            "kernel 5 (tma)": ck.tril_right3_tma,
            "kernel 3 (tma)": ck.tril_projection_3pass_tma}, A, L)
        bounds = {"product": right_bound(A, L, 1, F32_PEAK),
                  "rowsum": right_bound(A, L, 1, F32_PEAK, "rowsum"),
                  "3pass": right_bound(A, L, 3, BF16_PEAK)}
        times[name] = t, tq, t3, bounds
        q, n_, m = A.shape
        flop = q * n_ * m * (m + 1)

        def rate(ms, bound):
            return (f"{flop / ms / 1e9:.2f} TFLOP/s, {bound[0] / ms * 100:.1f}%"
                    f" of the bound")

        clocks = sampled_clocks(lambda: ck.tril_right_tma(A, L))
        b, k = bounds["product"], t["kernel 4 (tma)"]
        print(f"kernel 4 time, {name}: A tril(L) {k:.4f} ms ({rate(k, b)}), "
              f"cuBLAS "
              f"{t['cuBLAS']:.4f} ms ({rate(t['cuBLAS'], b)}), plain version "
              f"{t['plain']:.4f} ms; bound {b[0]:.4f} ms ({b[1]}, float32 at "
              f"{F32_PEAK / 1e12:g} TFLOP/s); median of {n} calls each; "
              f"kernel 4 back to back: {clocks} [card: {smi}]")
        b = bounds["rowsum"]
        k, kb = tq["kernel 4 (tma, rowsum)"], tq["kernel 4 (tma, both)"]
        print(f"quad_diag time, {name}: kernel 4 row sums alone {k:.4f} ms "
              f"({rate(k, b)}), with the product stored {kb:.4f} ms "
              f"({rate(kb, bounds['product'])}), cuBLAS then "
              f"square and sum {tq['cuBLAS, square, sum']:.4f} ms, plain "
              f"version {tq['plain']:.4f} ms; bound {b[0]:.4f} ms ({b[1]}) "
              f"[card: {smi}]")
        b, k = bounds["3pass"], t3["kernel 5 (tma)"]
        print(f"kernel 5 time, {name}: {k:.4f} ms ({b[0] / k * 100:.1f}% of "
              f"the bound), kernel 3 (the mirror) "
              f"{t3['kernel 3 (tma)']:.4f} ms, "
              f"plain version {t3['plain']:.4f} ms; bound {b[0]:.4f} ms "
              f"({b[1]}, bf16); no PyTorch call computes the 3-pass product"
              f" [card: {smi}]")
        del A, L, Lt

    # the "high" adjoints against float64 on the card: the flagship's own
    # (Luu, iLuu) and the VM step's Kfu rows, standard normal cotangents
    rows = 6 * TRAIN_B // 4
    gL = torch.tril(torch.randn(Luu.shape, generator=gen, device="cuda"))
    gP = torch.randn((Q, rows, M), generator=gen, device="cuda")

    def adjoints(dtype, precision, use_kernel):
        c = lambda t: t.detach().to(dtype)  # noqa: E731
        k = c(Luu @ Luu.mT).requires_grad_()
        (kbar,) = torch.autograd.grad(linalg.chol_cached(
            k, c(Luu), c(iLuu), precision=precision, use_kernel=use_kernel),
            k, c(gL))
        lv, kv = c(Luu).requires_grad_(), c(Kfu[:, :rows]).requires_grad_()
        lbar, kfubar = torch.autograd.grad(linalg.solve_tri_cached(
            lv, kv, c(iLuu), precision=precision, use_kernel=use_kernel),
            (lv, kv), c(gP))
        return {"Lbar": lbar, "Kbar": kbar, "Kfubar": kfubar}

    ref = adjoints(torch.float64, "highest", False)
    adj = {}
    for prec in ("highest", "high"):
        ck.zero_launch_counts()
        got = adjoints(torch.float32, prec, True)
        launched = {k: v for k, v in ck.launch_counts().items() if v}
        adj[prec] = {k: normwise(v, ref[k]) for k, v in got.items()}
        print(f"cached adjoints at \"{prec}\" (chol_cached at (4, 1024, "
              f"1024), solve_tri_cached on the VM step's {rows} rows) vs "
              f"float64 on the card, normwise: "
              + ", ".join(f"{k} {v:.3e}" for k, v in adj[prec].items())
              + f"; launches {launched} [card: {smi}]")
        want = "tril_right3_tma" if prec == "high" else "tril_right_tma"
        if launched.get(want, 0) != 4:
            raise AssertionError(f"the \"{prec}\" adjoints did not run their "
                                 f"four products on {want}: {launched}")
    print(f"the \"high\" adjoints beside the JAX package's own measurement "
          f"at Precision.HIGH: Lbar {adj['high']['Lbar']:.3e} (JAX "
          f"~{JAX_HIGH_LBAR:g}, bound {2 * JAX_HIGH_LBAR:g}), Kbar "
          f"{adj['high']['Kbar']:.3e} (JAX ~{JAX_HIGH_KBAR:g}, bound "
          f"{2 * JAX_HIGH_KBAR:g}) [card: {smi}]")
    if not (adj["high"]["Lbar"] <= 2 * JAX_HIGH_LBAR
            and adj["high"]["Kbar"] <= 2 * JAX_HIGH_KBAR):
        raise AssertionError("the \"high\" adjoints exceed twice the JAX "
                             "package's error")
    del ref, gL, gP

    t, tq, t3, bounds = times["training (4, 3072, 1024)"]
    model = "training Kfu, iLuu of the model"
    return [
        dict(proj_entry("tril_right_tma", "tril_right_kernel.cu",
                        "hetmogp_tpu/ops/linalg.py:561",
                        errs["k4", model], t, "kernel 4 (tma)",
                        "plain", bounds["product"]), library_ms=t["cuBLAS"]),
        dict(proj_entry("tril_right3_tma", "tril_right3_kernel.cu",
                        "hetmogp_tpu/ops/linalg.py:189",
                        errs["k5", model], t3, "kernel 5 (tma)",
                        "plain", bounds["3pass"]), library_ms=None)]


# Kernel 8 (tril(A^T B), tril_out_phase) against float64, normwise: the
# float32 routes within OUT_VS_PLAIN times the plain float32 product's
# error (cuBLAS's dense A^T B and mask: the same sums in another order)
# plus OUT_ABS; the 3-pass routes within PROJ3_VS_PLAIN times the plain
# 3-pass product's error against the float64 product of the split
# operands, and within PROJ3_VS_ONE_PASS of a 1-pass bf16 product's error
# against the unsplit one (kernel 5's bounds).  A lost tile, a part added
# twice or a wrong mask is off by a share of order one.
OUT_VS_PLAIN, OUT_ABS = 4.0, 1e-6
# its shapes: the VE step's gL (quad_diag's, on 6 x 512 rows), the VM
# step's Lbar (a quarter of the rows), and the ragged VM step's Lbar
OUT_SHAPES = {"VE (4, 3072, 1024)": (Q, 6 * TRAIN_B, M),
              "VM (4, 768, 1024)": (Q, 6 * TRAIN_B // 4, M),
              "ragged VM (4, 768, 777)": (Q, 6 * TRAIN_B // 4, RAGGED_M)}
# The recursive inverse of the flagship's Luu against float64, normwise:
# at most this multiple of trsm's error (a triangular solve against I).
INV_VS_TRSM = 2.0
# kernel 4's and kernel A's launches in one rec_tri_inverse at M = 1024:
# its levels below M (leaf 128), one of each a level
REFRESH_LEVELS = 3


def out_bound(A, passes: int, peak: float):
    """Bound of tril(A^T B): A and B read once, the (Q, M, M) output
    written once; ``passes`` products of the Q N M (M + 1) FLOPs of the
    lower triangle."""
    q, n, m = A.shape
    return bound_ms(4 * (2 * A.numel() + q * m * m),
                    passes * q * n * m * (m + 1), peak)


def tril_out_phase(smi: str, Luu: torch.Tensor) -> list:
    """Kernel 8 (tril(A^T B), only the lower tiles formed): the float32
    FFMA and the 3-pass wgmma TMA designs through their routers (the
    ragged VM step's M padded), each against its plain version and float64
    with exact zeros above the diagonal and two launches bitwise equal, at
    the VE and VM shapes and the ragged VM step's; timed in turns with
    cuBLAS's dense
    A^T B and mask and the plain versions, with bounds, TFLOP/s and the
    schedule's balance.  Then the recursive inverse (rec_tri_inverse, on
    kernels 4 and A) of the flagship's Luu against float64 beside trsm's,
    its residual, its launches, and its time beside trsm's."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import linalg

    from hetmogp_tpu_torch.ops import _build

    # ptxas -v of kernel 8's TMA designs (the build's log): their spills
    for kernel, line in _build.ptxas_lines(
            _build.library_path().with_suffix(".log").read_text()):
        if kernel in ("tril_out_tma_kernel", "tril_out3_tma_kernel"):
            print(f"kernel 8, ptxas, {kernel}: {line} [card: {smi}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    errs, times = {}, {}
    for name, shape in OUT_SHAPES.items():
        A = torch.randn(shape, generator=gen, device="cuda")
        B = torch.randn(shape, generator=gen, device="cuda")
        ref = torch.tril(A.double().mT @ B.double())
        ahi, alo = (t.double() for t in ck.split_bf16(A))
        bhi, blo = (t.double() for t in ck.split_bf16(B))
        ref_split = torch.tril((alo.mT @ bhi + ahi.mT @ blo) + ahi.mT @ bhi)
        del ahi, alo, bhi, blo
        plain = ck.t_matmul_tril_out_plain(A, B)
        plain3 = ck.t_matmul_tril_out_3pass_plain(A, B)
        one = torch.tril(A.to(torch.bfloat16).float().mT
                         @ B.to(torch.bfloat16).float())
        e_p, e_p3 = normwise(plain, ref), normwise(plain3, ref_split)
        f_1 = normwise(one, ref)
        del one
        m = shape[-1]
        upper = torch.triu(torch.ones(m, m, dtype=torch.bool,
                                      device="cuda"), 1)
        for three in (False, True):
            router = ck.tril_out3 if three else ck.tril_out
            launcher = ck.tril_out3_tma if three else ck.tril_out_tma
            before = launcher.launches
            got, again = router(A, B), router(A, B)
            zeros = not bool(got[:, upper].any())
            same = torch.equal(got, again)
            what = f"kernel 8 ({launcher.__name__}), {name}"
            if three:
                e_k, f_k = normwise(got, ref_split), normwise(got, ref)
                errs[launcher.__name__, name] = float(
                    (got - plain3).abs().max())
                ok = (e_k <= PROJ3_VS_PLAIN * e_p3
                      and f_k <= PROJ3_VS_ONE_PASS * f_1)
                print(f"{what}: normwise error vs f64 of the split operands "
                      f"{e_k:.3e}, plain 3-pass {e_p3:.3e} (bound "
                      f"{PROJ3_VS_PLAIN:g}x plain); vs f64 of the unsplit "
                      f"operands {f_k:.3e}, 1-pass bf16 {f_1:.3e} (bound "
                      f"{PROJ3_VS_ONE_PASS:g}x 1-pass); max abs difference "
                      f"from plain {errs[launcher.__name__, name]:.3e}; "
                      f"zeros above the diagonal {zeros}; two launches "
                      f"bitwise equal {same} [card: {smi}]")
            else:
                e_k = normwise(got, ref)
                errs[launcher.__name__, name] = float(
                    (got - plain).abs().max())
                ok = e_k <= OUT_VS_PLAIN * e_p + OUT_ABS
                print(f"{what}: normwise error vs f64 {e_k:.3e}, plain f32 "
                      f"(cuBLAS A^T B, tril) {e_p:.3e} (bound "
                      f"{OUT_VS_PLAIN:g}x plain + {OUT_ABS:g}); max abs "
                      f"difference from plain "
                      f"{errs[launcher.__name__, name]:.3e}; zeros above "
                      f"the diagonal {zeros}; two launches bitwise equal "
                      f"{same} [card: {smi}]")
            if not (ok and zeros and same
                    and launcher.launches == before + 2):
                raise AssertionError(f"{what}: out of bounds, not zero "
                                     "above the diagonal, not deterministic,"
                                     " or not two launches of the design")
            del got, again
        del ref, ref_split, plain, plain3, upper

        # through the routers: at the ragged shape the padding's copies too
        t, n = time_in_turns({"plain": ck.t_matmul_tril_out_plain,
                              "plain 3-pass": ck.t_matmul_tril_out_3pass_plain,
                              "kernel 8": ck.tril_out,
                              "kernel 8 3-pass": ck.tril_out3}, A, B)
        bounds = {"f32": out_bound(A, 1, F32_PEAK),
                  "3pass": out_bound(A, 3, BF16_PEAK)}
        times[name] = t, bounds
        q, n_, m = A.shape
        flop = q * n_ * m * (m + 1)

        def rate(ms, bound):
            return (f"{flop / ms / 1e9:.2f} TFLOP/s a pass, "
                    f"{bound[0] / ms * 100:.1f}% of the bound")

        balance = ""
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sched = (ctypes.c_longlong * 7)()
        for three in (0, 1):
            # the schedule of the padded width the routers launch
            ck._library().hetmogp_tril_out_schedule(q, n_, -(-m // 4) * 4,
                                                    three, sms, sched)
            G, F, rem, P, busy, total, reads = list(sched)
            # the units: whole tiles, and the parts of the split ones
            balance += (f"; {'3-pass' if three else 'f32'} schedule: "
                        f"{G} blocks, {F} whole turns ({F * G} whole "
                        f"tiles), {rem} tiles cut into {P} parts "
                        f"({rem * P} parts, the last turn), balance "
                        f"{total / G / busy:.3f}, the fix-up's reads "
                        f"a block {reads} float4s ({reads * 16 / 1024:.1f}"
                        f" KB: {P} partials of 1/{P} of a tile)")
        b, k = bounds["f32"], t["kernel 8"]
        b3, k3 = bounds["3pass"], t["kernel 8 3-pass"]
        print(f"kernel 8 time, {name}: f32 {k:.4f} ms ({rate(k, b)}; bound "
              f"{b[0]:.4f} ms, {b[1]}), 3-pass {k3:.4f} ms "
              f"({rate(k3, b3)}; bound {b3[0]:.4f} ms, {b3[1]}) "
              f"[card: {smi}]")
        print(f"kernel 8 time, {name}: cuBLAS's dense A^T B and mask (the "
              f"plain version, what the port ran before) {t['plain']:.4f} "
              f"ms ({rate(t['plain'], bounds['f32'])}), plain 3-pass "
              f"{t['plain 3-pass']:.4f} ms; median of {n} calls each"
              f"{balance} [card: {smi}]")
        del A, B
    torch.cuda.empty_cache()

    # the recursive inverse of the flagship's Luu, beside trsm against I
    eye = torch.eye(M, device="cuda").expand_as(Luu)
    eye64 = torch.eye(M, dtype=torch.float64, device="cuda")
    ref = torch.linalg.solve_triangular(Luu.double(), eye64.expand_as(Luu),
                                        upper=False)
    ck.zero_launch_counts()
    rec = linalg.rec_tri_inverse(Luu)
    torch.cuda.synchronize()
    launched = {k: v for k, v in ck.launch_counts().items() if v}
    trsm = torch.linalg.solve_triangular(Luu, eye, upper=False)
    e_rec, e_trsm = normwise(rec, ref), normwise(trsm, ref)
    res_rec, res_trsm = (float((Luu.double() @ X.double() - eye64).abs()
                               .max()) for X in (rec, trsm))
    t, n = time_in_turns({
        "rec_tri_inverse": lambda: linalg.rec_tri_inverse(Luu),
        "trsm against I": lambda: torch.linalg.solve_triangular(
            Luu, eye, upper=False)})
    print(f"rec_tri_inverse of the flagship's Luu ({Q}, {M}, {M}): "
          f"normwise error vs float64 {e_rec:.3e}, trsm against I "
          f"{e_trsm:.3e} (bound {INV_VS_TRSM:g}x trsm); residual "
          f"max|tril(L) iL - I| {res_rec:.3e}, trsm {res_trsm:.3e}; "
          f"launches {launched}; device ms (median of {n}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f" [card: {smi}]")
    if not (e_rec <= INV_VS_TRSM * e_trsm and torch.isfinite(rec).all()
            and not torch.triu(rec, 1).any()
            and launched == {"tril_right_tma": REFRESH_LEVELS,
                             "tril_projection_tma": REFRESH_LEVELS}):
        raise AssertionError("the recursive inverse is off, or did not run "
                             "on kernels 4 and A")
    del ref, rec, trsm

    ve = "VE (4, 3072, 1024)"
    entries = []
    for launcher, shape, passes in (("tril_out_tma", ve, "f32"),
                                    ("tril_out3_tma", ve, "3pass")):
        t, bounds = times[shape]
        key = "kernel 8 3-pass" if passes == "3pass" else "kernel 8"
        entries.append(dict(
            proj_entry(launcher, "tril_out_kernel.cu",
                       "hetmogp_tpu/ops/linalg.py:636",
                       errs[launcher, shape], t, key,
                       "plain 3-pass" if passes == "3pass" else "plain",
                       bounds[passes]),
            # cuBLAS's dense product and mask computes the float32
            # function; no PyTorch call computes the 3-pass one
            library_ms=t["plain"] if passes == "f32" else None))
    return entries


# ---------------------------------------------------------------------------
# the factorization: cuSOLVER's potrf, and the blocked panels on kernel 9
# ---------------------------------------------------------------------------

# The blocked pair (L, iL) of the flagship's Kuu against float64,
# normwise, each at most this multiple of potrf's and trsm's (cuSOLVER's
# factor and a triangular solve against I): INV_VS_TRSM's bound, which
# tril_out_phase holds rec_tri_inverse to.
FACTOR_VS_POTRF = INV_VS_TRSM
# Kernel 9 against float64, normwise, in float32: at most this multiple of
# its plain version's error (cholesky_ex and a triangular solve against I)
# plus an absolute term; the two sum in other orders.  Float64: within
# PANEL_F64 of the plain float64 version on a well-conditioned panel.
PANEL_VS_PLAIN, PANEL_ABS, PANEL_F64 = 4.0, 1e-6, 1e-12
# One refresh of (Luu, iLuu) at M = 1024 in panels of 128: kernel 9 on
# each of its 8 diagonal panels, kernel A twice on the rows below 7 of them
# (the product and its refinement) and kernel 4 on the inverse's 7 row
# strips.
PANEL = 128
REFRESH_PANELS = M // PANEL
REFRESH_STRIPS = REFRESH_PANELS - 1
REFRESH_BELOW = 2 * REFRESH_STRIPS


def refresh_shapes(q: int) -> dict:
    """{launcher: {(Q, N, M), ...}} of one refresh of q latents' (Luu,
    iLuu) at M = 1024: kernel 9's panels, kernel A's rows below each panel
    (N rows at the panel's depth, twice) and kernel 4's strips (a panel's rows
    at the depth of the inverse above them)."""
    return {"chol_panel": {(q, PANEL, PANEL)},
            "tril_projection_tma": {(q, M - r1, PANEL)
                                    for r1 in range(PANEL, M, PANEL)},
            "tril_right_tma": {(q, PANEL, r0) for r0 in range(PANEL, M,
                                                               PANEL)}}


def flagship_kuu(m=M, q=Q) -> torch.Tensor:
    """Kuu + jitter I of the serving model (the flagship's Z, lengthscale,
    variance and jitter): what a refresh factorizes."""
    from hetmogp_tpu_torch.models import elbo

    cfg, params, _ = serving_model(m=m, q=q)
    with torch.no_grad():
        return elbo._jittered_gram(params, cfg)


def operand_copies(call) -> int:
    """The contiguous copies (``aten::clone``, what ``.contiguous()`` of a
    strided tensor makes) in one ``call``, from torch.profiler's record of
    its ATen ops."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == "aten::clone")


def factor_phase(smi: str) -> list:
    """Kernel 9 and the blocked factorization on the card: kernel 9 against
    its plain version and float64 in float32 (a diagonal panel of the
    flagship's Kuu, read through its strides, and random panels of 128,
    100 and 9, the ragged M = 777's last) and float64, with exact zeros
    above the diagonal, NaN for a non-SPD panel and two launches bitwise
    equal; the blocked pair (L, iL) of the flagship's Kuu and of the
    ragged M = 777's against float64 beside potrf's and trsm's errors, its
    launches, NaN from the failing panel on, a CUDA graph of it replayed
    bitwise equal to the eager call, and its profile; a refresh's time
    both ways in turns, eager and as replayed graphs.  Returns kernel 9's
    entry of the kernel table.  (The library's own factorization, potrf's
    kernels at the port's batch shapes, is measured by
    ``hetmogp_tpu_torch/probes/ab_phases.py --phases factor``.)"""
    from hetmogp_tpu_torch.ops import _build
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import linalg

    # ptxas's registers and spills of both instantiations, and the dynamic
    # shared memory a launch asks for (sized to its width)
    for kernel, line in _build.ptxas_lines(
            _build.library_path().with_suffix(".log").read_text()):
        if kernel.startswith("chol_panel_kernel"):
            print(f"kernel 9, ptxas, {kernel}: {line} [card: {smi}]")
    print("kernel 9 dynamic shared memory, bytes at n = 1, 9, 33, 128: "
          + "; ".join(f"{str(dt).split('.')[-1]} "
                      + ", ".join(str(ck.chol_panel_smem(dt, w))
                                  for w in (1, 9, 33, PANEL))
                      for dt in (torch.float32, torch.float64))
          + f" [card: {smi}]")

    K = flagship_kuu()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)

    def rand_spd(q, n, dtype):
        X = torch.randn(q, n, n + 8, generator=gen, device="cuda",
                        dtype=torch.float64)
        return (X @ X.mT / n + torch.eye(n, device="cuda",
                                         dtype=torch.float64)).to(dtype)

    cases = {"flagship panel (4, 128, 128), a view of Kuu":
             K[:, :PANEL, :PANEL],
             "random (4, 128, 128)": rand_spd(Q, PANEL, torch.float32),
             "random (4, 100, 100)": rand_spd(Q, 100, torch.float32),
             "random (4, 9, 9)": rand_spd(Q, 9, torch.float32)}
    err = 0.0
    for name, A in cases.items():
        ref = ck.chol_panel_plain(A.double())
        plain = ck.chol_panel_plain(A)
        got, again = ck.chol_panel(A), ck.chol_panel(A)
        e_k = max(normwise(g, r) for g, r in zip(got, ref))
        e_p = max(normwise(g, r) for g, r in zip(plain, ref))
        diff = max(float((g - p).abs().max()) for g, p in zip(got, plain))
        zeros = not any(bool(torch.triu(g, 1).any()) for g in got)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if name.startswith("flagship"):
            err = diff
        print(f"kernel 9 (chol_panel), {name}, float32: normwise error of "
              f"(L, iL) vs float64 {e_k:.3e}, plain (cholesky_ex, trsm) "
              f"{e_p:.3e} (bound {PANEL_VS_PLAIN:g}x plain + "
              f"{PANEL_ABS:g}); max abs difference from plain {diff:.3e}; "
              f"zeros above the diagonal {zeros}; two launches bitwise "
              f"equal {same} [card: {smi}]")
        if not (e_k <= PANEL_VS_PLAIN * e_p + PANEL_ABS and zeros and same):
            raise AssertionError(f"kernel 9 at {name}: out of bounds, not "
                                 "zero above the diagonal, or not "
                                 "deterministic")
    A64 = rand_spd(Q, PANEL, torch.float64)
    got, want = ck.chol_panel(A64), ck.chol_panel_plain(A64)
    e64 = max(normwise(g, w) for g, w in zip(got, want))
    bad = rand_spd(Q, PANEL, torch.float32)
    bad[2, 70, 70] = -1.0
    nan = ck.chol_panel(bad)
    rows, cols = torch.tril_indices(PANEL, PANEL, device="cuda")
    nan_ok = (bool(torch.isnan(nan[0][2][rows, cols]).all())
              and not bool(torch.triu(nan[0][2], 1).any())
              and bool(torch.isnan(nan[1][2]).all())
              and all(bool(torch.isfinite(t[[0, 1, 3]]).all()) for t in nan))
    print(f"kernel 9, float64 (4, 128, 128): normwise from the plain float64 "
          f"version {e64:.3e} (bound {PANEL_F64:g}); a non-SPD panel: that "
          f"matrix's L NaN on and below the diagonal and zero above, its iL "
          f"NaN, the others finite {nan_ok} [card: {smi}]")
    if not (e64 <= PANEL_F64 and nan_ok):
        raise AssertionError("kernel 9 in float64, or its NaN contract, is "
                             "off")

    # the blocked pair against float64, beside potrf's and trsm's
    for what, Kc in (("flagship (4, 1024, 1024)", K),
                     (f"ragged (4, {RAGGED_M}, {RAGGED_M})",
                      flagship_kuu(m=RAGGED_M))):
        m = Kc.shape[-1]
        L64 = torch.linalg.cholesky(Kc.double())
        eye64 = torch.eye(m, dtype=torch.float64, device="cuda")
        iL64 = torch.linalg.solve_triangular(L64, eye64.expand_as(L64),
                                             upper=False)
        ck.zero_launch_counts()
        L, iL = linalg.blocked_cholesky_inverse(Kc)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ck.launch_counts().items() if v}
        # kernels A and 4 read the panels' views where TMA can address
        # them (rows a multiple of 16 bytes apart), else copies
        copies = operand_copies(lambda: linalg.blocked_cholesky_inverse(Kc))
        Lp = linalg.cholesky(Kc)
        iLp = torch.linalg.solve_triangular(
            Lp, torch.eye(m, device="cuda").expand_as(Lp), upper=False)
        errs = [normwise(a, b) for a, b in ((L, L64), (iL, iL64),
                                            (Lp, L64), (iLp, iL64))]
        zeros = not (torch.triu(L, 1).any() or torch.triu(iL, 1).any())
        panels = -(-m // PANEL)
        want = {"chol_panel": panels,
                "tril_projection_tma": 2 * (panels - 1),
                "tril_right_tma": panels - 1}
        print(f"blocked_cholesky_inverse, {what}: normwise error vs float64 "
              f"L {errs[0]:.3e}, iL {errs[1]:.3e}; potrf {errs[2]:.3e}, trsm "
              f"against I {errs[3]:.3e} (bound {FACTOR_VS_POTRF:g}x each); "
              f"zeros above the diagonal {zeros}; launches {launched}; "
              f"operands copied to reach kernels A and 4 {copies} "
              f"[card: {smi}]")
        if not (errs[0] <= FACTOR_VS_POTRF * errs[2]
                and errs[1] <= FACTOR_VS_POTRF * errs[3] and zeros
                and launched == want and (m % 4 or copies == 0)):
            raise AssertionError(f"the blocked pair at {what} is off, did "
                                 "not run on kernels 9, A and 4, or copied "
                                 "views TMA can read")
        del L64, iL64, L, iL, Lp, iLp

    # NaN from the failing panel on; a graph replay bitwise the eager call
    Kbad = K.clone()
    Kbad[1, 400, 400] = -1.0
    L, iL = linalg.blocked_cholesky_inverse(Kbad)
    first = 400 // PANEL * PANEL
    nan_ok = (bool(torch.isfinite(L[[0, 2, 3]]).all())
              and bool(torch.isfinite(iL[[0, 2, 3]]).all())
              and bool(torch.isfinite(L[1, :, :first]).all())
              and bool(torch.isnan(L[1, first + PANEL:,
                                     first:first + PANEL]).all())
              and bool(torch.isnan(L[1, first:first + PANEL,
                                     first:first + PANEL][rows, cols]).all())
              and not bool(torch.triu(L[1], 1).any())
              and bool(torch.isfinite(iL[1, :first, :first]).all())
              and bool(torch.isnan(iL[1, first:, :first + 1]).all()))
    eager = linalg.blocked_cholesky_inverse(K)
    static = K.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        linalg.blocked_cholesky_inverse(static)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = linalg.blocked_cholesky_inverse(static)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(captured, eager))
    print(f"blocked_cholesky_inverse, a non-SPD Kuu (matrix 1, pivot 400): "
          f"the other matrices and the panels before the failing one "
          f"finite, NaN from the failing panel on (L's columns on and below "
          f"the diagonal, iL's rows) "
          f"{nan_ok}; a CUDA graph of it replayed bitwise equal to the "
          f"eager call {bitwise} [card: {smi}]")
    if not (nan_ok and bitwise):
        raise AssertionError("the blocked pair's NaN contract or its graph "
                             "replay is off")
    del graph, captured, eager, static
    profile(lambda: linalg.blocked_cholesky_inverse(K),
            "factorization, blocked_cholesky_inverse (4, 1024, 1024)", smi)

    # timed in turns: kernel 9 at the panel shape, and a refresh both ways
    panel = K[:, :PANEL, :PANEL].contiguous()
    panel64 = panel.double()
    eye = torch.eye(PANEL, device="cuda").expand_as(panel)
    t, n = time_in_turns({
        "kernel 9": lambda: ck.chol_panel(panel),
        "plain (cholesky_ex, where, trsm)": lambda: ck.chol_panel_plain(panel),
        "cholesky_ex and trsm against I": lambda: torch.linalg
        .solve_triangular(torch.linalg.cholesky_ex(panel)[0], eye,
                          upper=False),
        "kernel 9, float64": lambda: ck.chol_panel(panel64),
        "plain, float64": lambda: ck.chol_panel_plain(panel64),
        "empty kernel": ck.empty_launch})
    # bytes: A's lower triangle read, L and iL written whole (their zeros
    # above the diagonal are part of the output); operations: n^3 / 3 each
    # for the factor and the inverse
    q, m = panel.shape[0], panel.shape[-1]
    bound = bound_ms(4 * q * (m * (m + 1) // 2 + 2 * m * m),
                     2 * q * m ** 3 / 3, F32_PEAK)
    print(f"kernel 9 time (4, 128, 128): kernel {t['kernel 9']:.4f} ms, plain "
          f"{t['plain (cholesky_ex, where, trsm)']:.4f}, cholesky_ex and trsm "
          f"{t['cholesky_ex and trsm against I']:.4f}, empty kernel "
          f"{t['empty kernel']:.4f} (median of {n}); bound {bound[0]:.6f} "
          f"ms, {bound[1]} ({bound[0] / t['kernel 9'] * 100:.2f}%) "
          f"[card: {smi}]")
    bound64 = bound_ms(8 * q * (m * (m + 1) // 2 + 2 * m * m),
                       2 * q * m ** 3 / 3, F32_PEAK / 2)
    print(f"kernel 9 time (4, 128, 128) float64: kernel "
          f"{t['kernel 9, float64']:.4f} ms, plain "
          f"{t['plain, float64']:.4f} (median of {n}); bound "
          f"{bound64[0]:.6f} ms, {bound64[1]} "
          f"({bound64[0] / t['kernel 9, float64'] * 100:.2f}%; float64 "
          f"operations at half the float32 rate) [card: {smi}]")
    # the chain's length: kernel 9 at each width, on and just past the
    # sub-panel edges
    widths = {f"kernel 9, n = {w}": (lambda w=w: ck.chol_panel(
        panel[:, :w, :w])) for w in (1, 8, 16, 32, 33, 64, 65, 96, 97,
                                     PANEL)}
    tw, n = time_in_turns(widths)
    print("kernel 9 by panel width, (4, n, n), device ms (median of "
          f"{n}, in turns): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tw.items())
          + f" [card: {smi}]")
    refresh = {"potrf and rec_tri_inverse":
               lambda: linalg.rec_tri_inverse(linalg.cholesky(K)),
               "blocked_cholesky_inverse (kernel 9)":
               lambda: linalg.blocked_cholesky_inverse(K),
               "blocked_cholesky (the panels alone)":
               lambda: linalg.blocked_cholesky(K),
               "potrf": lambda: linalg.cholesky(K)}
    tr, n = time_in_turns(refresh)
    print("a refresh of the flagship's (Luu, iLuu), eager, device ms (median "
          f"of {n}, in turns; the blocked pair's ~80 launches outlast the "
          "device sleep, so its number holds host time): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tr.items())
          + f" [card: {smi}]")
    # as the trainer runs it: each refresh captured in a CUDA graph, the
    # replays timed in turns
    graphs = {}
    for name, fn in refresh.items():
        fn()  # warm-up: cuBLAS and cuSOLVER handles, the allocator
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            fn()
    tg, n = time_in_turns({k: g.replay for k, g in graphs.items()})
    print("a refresh of the flagship's (Luu, iLuu), each a CUDA graph "
          f"replayed, device ms (median of {n}, in turns): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tg.items())
          + f" [card: {smi}]")
    del graphs
    return [dict(proj_entry("chol_panel", "chol_panel_kernel.cu",
                            "hetmogp_tpu/ops/linalg.py:411", err, t,
                            "kernel 9", "plain (cholesky_ex, where, trsm)",
                            bound),
                 library_ms=t["cholesky_ex and trsm against I"])]


# The ragged VM step's hyper gradients (ragged_adjoint_phase) against
# float64, normwise: at most this multiple of the plain route's error.
# Both multiply the same 3-pass split of the same operands; the VM step's
# hyper gradients cancel large terms (the adjoints through iLuu against
# Kfu's), so both sit near 2e-2 of float64 (3-pass) where "highest" sits
# near 1e-3; a lost or doubled term would move them by orders more.
RAGGED_GRAD_VS_PLAIN = 4.0


def ragged_adjoint_phase(smi: str) -> dict:
    """Kernels 4, 5 and 8 on padded operands: the VM step's
    loss of the serving model at RAGGED_M inducing points (``elbo_fn``
    with the cached inverse and ``cache_grad``) at "high" and at
    "highest", differentiated in its hypers, with the counts from 0,
    against the plain versions and float64.  Returns the launch counts of
    both."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.models import elbo as telbo
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    cfg, params, X = serving_model(m=RAGGED_M)
    rng = np.random.RandomState(SEED + 16)
    n = 6 * TRAIN_B // 4 // cfg.num_tasks  # the VM step's rows a task
    Y = [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
         rng.randint(1, 4, (n, 1)).astype(float),
         rng.poisson(3.0, (n, 1)).astype(float),
         rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
         rng.exponential(1.0, (n, 1)) + 1e-3]
    X_list = [X[t * n:(t + 1) * n].cpu().numpy()
              for t in range(cfg.num_tasks)]

    def grads(dtype, use_kernel, precision="high"):
        c = dataclasses.replace(cfg, ve_fwd_precision=precision, dtype=dtype)
        p = params.to(dtype=c.torch_dtype)
        data = tp.make_dataset(X_list, Y, c)
        scales = torch.full((c.num_tasks,), 100.0, dtype=c.torch_dtype,
                            device="cuda")
        with torch.no_grad():
            Luu, iLuu = telbo.prior_cholesky_inverse(p, c)
        hypers = dataclasses.replace(
            p, Z=p.Z.clone().requires_grad_(),
            log_lengthscale=p.log_lengthscale.clone().requires_grad_())
        ck.zero_launch_counts()
        elbo, _ = telbo.elbo_fn(hypers, data, scales, c, Luu=Luu,
                                iLuu=iLuu, cache_grad=True,
                                use_kernel=use_kernel)
        out = torch.autograd.grad(elbo, (hypers.Z, hypers.log_lengthscale))
        torch.cuda.synchronize()
        return out, ck.launch_counts()

    ref, _ = grads("float64", False)
    total = {}
    # at "high": kernel 5's four adjoint products and kernel 8's Lbar in
    # three passes; at "highest": kernel 4's and kernel 8's float32 ones;
    # quad_diag's forward on kernel 4 (q(u) is frozen: no gL); each on its
    # TMA design, M padded to 780
    want = {"high": {"tril_right3_tma": 4, "tril_right_tma": 1,
                     "tril_out3_tma": 1},
            "highest": {"tril_right_tma": 5, "tril_out_tma": 1}}
    for prec in ("high", "highest"):
        got, counts = grads("float32", True, prec)
        plain, _ = grads("float32", False, prec)
        e_k = max(normwise(a, b) for a, b in zip(got, ref))
        e_p = max(normwise(a, b) for a, b in zip(plain, ref))
        launched = {k: v for k, v in counts.items() if v}
        mine = {k: v for k, v in launched.items()
                if k.startswith(("tril_right", "tril_out"))}
        print(f"ragged VM step (M={RAGGED_M}, \"{prec}\", {cfg.num_tasks} x "
              f"{n} rows): launches {launched}; hyper gradients (Z, log "
              f"lengthscale) vs float64 {e_k:.3e} "
              f"normwise, the plain route {e_p:.3e} (bound "
              f"{RAGGED_GRAD_VS_PLAIN:g}x plain) [card: {smi}]")
        if not (mine == want[prec] and e_k <= RAGGED_GRAD_VS_PLAIN * e_p):
            raise AssertionError(f"the ragged VM step at {prec!r} did not "
                                 f"run the TMA designs {want[prec]}, or "
                                 "disagrees")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def rbf_backward_phase(smi: str):
    """RBFCrossCovariance's gradient against autograd through the plain
    RBF at the training shape, in float32 and float64."""
    from hetmogp_tpu_torch.ops import cuda_kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    X = torch.rand(6 * TRAIN_B, DX, generator=gen, device="cuda")
    Z = torch.rand(Q, M, DX, generator=gen, device="cuda")
    ls = 0.2 + 0.1 * torch.rand(Q, DX, generator=gen, device="cuda")
    var = 0.5 + torch.rand(Q, generator=gen, device="cuda")
    g = torch.randn(Q, 6 * TRAIN_B, M, generator=gen, device="cuda")

    def grads(fn, dtype):
        t = [a.detach().to(dtype).requires_grad_() for a in (X, Z, ls, var)]
        return torch.autograd.grad(fn(*t), t, g.to(dtype))

    got = grads(cuda_kernels.RBFCrossCovariance.apply, torch.float32)
    want32 = grads(cuda_kernels.rbf_K_batched_plain, torch.float32)
    want64 = grads(cuda_kernels.rbf_K_batched_plain, torch.float64)
    t64 = [a.double() for a in (X, Z, ls, var)]
    got64 = cuda_kernels.rbf_K_batched_bwd(
        *t64, cuda_kernels.rbf_K_batched_plain(*t64), g.double())
    for name, a, b, c, d in zip(("dX", "dZ", "dls", "dvar"), got, want32,
                                want64, got64):
        e32, e_vs64 = normwise(a, b), normwise(a, c)
        e64 = normwise(d, c)
        print(f"rbf backward {name}: f32 Function vs f32 autograd {e32:.3e}, "
              f"vs f64 autograd {e_vs64:.3e}; f64 algebra vs f64 autograd "
              f"{e64:.3e} (bounds {RBF_BWD_F32:g}, {RBF_BWD_F64:g}) "
              f"[card: {smi}]")
        if not (e32 <= RBF_BWD_F32 and e64 <= RBF_BWD_F64):
            raise AssertionError(f"rbf backward {name} disagrees")


def training_arrays():
    """(config, train config, X_list, Y_list, rng) of the flagship of
    bench.py:172-217 at full width: the bench's own arrays from
    RandomState(0), jitter 1e-4, float32, adam, slice minibatches, the VM
    step on a quarter of the batch; ``rng`` is left where the arrays end,
    for Z and the initial parameters."""
    import hetmogp_tpu_torch as tp

    liks = (tp.HetGaussian(), tp.Bernoulli(), tp.Categorical(K=3),
            tp.Poisson(), tp.Gamma(), tp.Exponential())
    n = TRAIN_N_PER
    rng = np.random.RandomState(SEED)
    X_list = [rng.rand(n, DX).astype(np.float32) for _ in liks]
    Y_list = [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
              rng.randint(1, 4, (n, 1)).astype(float),
              rng.poisson(3.0, (n, 1)).astype(float),
              rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
              rng.exponential(1.0, (n, 1)) + 1e-3]
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                         input_dim=DX, dtype="float32", jitter=1e-4,
                         adaptive_jitter=False, fuse_task_rows=True)
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.005, minibatch="slice",
                        vm_batch_fraction=0.25)
    return cfg, tc, X_list, Y_list, rng


def training_model(device="cuda", precision="highest", **config):
    """The flagship model and data of bench.py:172-217 at full width
    (``training_arrays``): Z = rng.rand(M, 2), lengthscale 0.2, variance
    0.5, q_mu_scale 0.1, the VE projection at ``precision`` (the bench runs
    "high"), other ModelConfig fields from ``config`` (rank, chol_dtype)."""
    import hetmogp_tpu_torch as tp

    cfg, tc, X_list, Y_list, rng = training_arrays()
    cfg = dataclasses.replace(cfg, ve_fwd_precision=precision, **config)
    Z = rng.rand(M, DX).astype(np.float32)
    params = tp.init_params(rng, cfg, Z, lengthscale=0.2, variance=0.5,
                            q_mu_scale=0.1, device=device)
    dataset = tp.prepare_dataset_on_device(cfg, X_list, Y_list, device=device)
    return cfg, tc, params, dataset


def _counts():
    """(kernel A launches, RBF launches, RBF backward passes, kernel 4 and
    5 launches, kernel 8 launches)."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    c = ck.launch_counts()
    return (c["tril_projection_tma"],
            c["rbf_K_batched_vec"] + c["rbf_K_batched_scalar"],
            c["rbf_backward"], c["tril_right_tma"] + c["tril_right3_tma"],
            c["tril_out_tma"] + c["tril_out3_tma"])


def _zero_counts():
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    ck.zero_launch_counts()


def training_phase(smi: str):
    """The host-loop trainer at "highest": parity, launches, steps/s, ELBO,
    profile.  Returns (Kfu, Luu, iLuu) of the model after ten steps."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    cfg, tc, params, dataset = training_model()
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    cycle = tc.ve_steps_per_vm + 1

    # ten steps with the kernels, with the plain versions, and in float64
    ext = ttrain.extend_for_wraparound(dataset, batches, sizes)
    gen = torch.Generator().manual_seed(SEED + 1)
    offsets = [ttrain.draw_offsets(gen, sizes, batches) for _ in range(10)]
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    ext64 = tuple(tp.TaskData(*(a.double() for a in td)) for td in ext)
    runs = {"kernels": (cfg, ext, params, True),
            "plain_f32": (cfg, ext, params, False),
            "plain_f64": (cfg64, ext64, params.to(dtype=torch.float64),
                          False)}
    elbos = {}
    for name, (c, data, p, use_kernel) in runs.items():
        step = ttrain.make_step(c, tc, use_kernel=use_kernel)
        state = tp.init_train_state(p, c)
        scales = ttrain.batch_scales(sizes, batches, c.torch_dtype, "cuda")
        out = []
        for i, off in enumerate(offsets):
            before = _counts()
            before67 = (ck.task_var_exp.launches
                        + ck.task_var_exp_backward.launches,
                        ck.adam_update.launches, ck.chol_panel.launches)
            state, metrics = step(
                state, ttrain.slice_batch(data, off, sizes, batches), scales)
            out.append(metrics["elbo"])
            sweeps, adams, panels = (ck.task_var_exp.launches
                                     + ck.task_var_exp_backward.launches
                                     - before67[0],
                                     ck.adam_update.launches - before67[1],
                                     ck.chol_panel.launches - before67[2])
            if use_kernel:
                tril, rbf, bwd, right, out8 = (
                    a - b for a, b in zip(_counts(), before))
                vm = i % cycle == tc.ve_steps_per_vm
                print(f"  step {i} ({'VM' if vm else 'VE'}): projection "
                      f"kernel launches {tril}, rbf kernel launches {rbf}, "
                      f"rbf backward passes {bwd}, kernel 4 launches "
                      f"{right}, kernel 8 launches {out8}, kernel 6 (task "
                      f"table, forward and backward) {sweeps}, kernel 7 "
                      f"{adams}, kernel 9 {panels} [card: {smi}]")
                # quad_diag a step; the VM step's four adjoint products
                # and the refresh's strips; quad_diag's gL (VE) or the
                # solve's Lbar (VM); the task table's forward and backward
                # and the adam update; the refresh's diagonal panels
                if (tril < 1 or rbf < 1 or (vm and bwd < 1)
                        or right != (5 + REFRESH_STRIPS if vm else 1)
                        or out8 != 1 or sweeps != 2 or adams != 1
                        or panels != (REFRESH_PANELS if vm else 0)):
                    raise AssertionError(f"step {i} did not run the kernels")
            elif sweeps or adams:
                raise AssertionError(f"the plain step {i} launched kernel 6 "
                                     "or 7")
        elbos[name] = torch.stack(out).double().cpu()
        if name == "kernels":
            trained = state
    def rel(a, b):
        return (elbos[a] - elbos[b]).abs() / elbos[b].abs()

    first_vm = tc.ve_steps_per_vm + 1  # ELBOs before any hyper update
    rel32_ve = float(rel("kernels", "plain_f32")[:first_vm].max())
    rel32 = float(rel("kernels", "plain_f32").max())
    rel64 = float(rel("kernels", "plain_f64").max())
    for name in elbos:
        print(f"ten host-loop steps, ELBO per step, {name}: "
              f"{elbos[name].numpy().round(3).tolist()} [card: {smi}]")
    print(f"  max relative ELBO difference: vs plain f32 {rel32_ve:.3e} up to "
          f"the first VM step (bound {TRAIN_PLAIN_F32_VE:g}), {rel32:.3e} "
          f"over all ten (bound {TRAIN_PLAIN_F32:g}); vs plain f64 "
          f"{rel64:.3e} (bound {TRAIN_F64:g}) [card: {smi}]")
    if not (torch.isfinite(elbos["kernels"]).all()
            and rel32_ve <= TRAIN_PLAIN_F32_VE and rel32 <= TRAIN_PLAIN_F32
            and rel64 <= TRAIN_F64):
        raise AssertionError("trainer disagrees with its plain versions")

    # the model's own (Kfu, iLuu) at the training shape, for phases 2 and 3
    from hetmogp_tpu_torch.ops import kernels
    with torch.no_grad():
        batch = ttrain.slice_batch(ext, offsets[0], sizes, batches)
        p = trained.params
        Kfu = kernels.K_batched("rbf", torch.cat([td.X for td in batch]),
                                p.Z, p.lengthscale, p.variance,
                                use_kernel=False)
        Luu, iLuu = trained.Luu, trained.iLuu

    # the host loop: one call with the counts from 0, then timed calls
    run = tp.make_trainer(cfg, tc, sizes, batches,
                          steps_per_call=HOST_CALL_STEPS)
    state = tp.init_train_state(params, cfg)
    gen = torch.Generator().manual_seed(SEED + 2)
    _zero_counts()
    t0 = time.perf_counter()
    state, first = run(state, dataset, gen)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counts = _counts()
    n_vm = HOST_CALL_STEPS // cycle
    print(f"host-loop call of {HOST_CALL_STEPS} steps (warm-up, {warm:.3f} "
          f"s): projection kernel launches {counts[0]}, rbf kernel launches "
          f"{counts[1]}, rbf backward passes {counts[2]}, kernel 4 launches "
          f"{counts[3]}, kernel 8 launches {counts[4]} ({n_vm} VM steps) "
          f"[card: {smi}]")
    if (counts[0] < HOST_CALL_STEPS or counts[1] < HOST_CALL_STEPS
            or counts[2] < n_vm
            or counts[3] != HOST_CALL_STEPS + (4 + REFRESH_STRIPS) * n_vm
            or ck.chol_panel.launches != REFRESH_PANELS * n_vm
            or counts[4] != HOST_CALL_STEPS):
        raise AssertionError("the trainer did not go through the kernels")

    calls = [first]
    rates = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter()
        state, e = run(state, dataset, gen)
        torch.cuda.synchronize()
        rates.append(HOST_CALL_STEPS / (time.perf_counter() - t0))
        calls.append(e)
    report_rates("host-loop trainer (make_trainer, \"highest\")", rates,
                 HOST_CALL_STEPS, smi)
    e = torch.cat(calls).double().cpu()
    start, end = float(e[:10].mean()), float(e[-10:].mean())
    print(f"host-loop ELBO over {e.numel()} steps: mean of the first ten "
          f"{start:.3f}, of the last ten {end:.3f}, final {float(e[-1]):.3f}"
          f" [card: {smi}]")
    if not (torch.isfinite(e).all() and end > start):
        raise AssertionError("ELBO not finite or not rising")

    profile(lambda: run(state, dataset, gen), "host-loop trainer, "
            f"{HOST_CALL_STEPS} steps", smi)
    return Kfu, Luu, iLuu


def report_rates(what: str, rates, steps: int, smi: str) -> float:
    """Print the median, min, max, spread and samples of steps/s."""
    rates = sorted(rates)
    med = statistics.median(rates)
    print(f"{what} throughput: {med:.2f} steps/s, median of {len(rates)} "
          f"calls of {steps} steps, min {rates[0]:.2f}, max {rates[-1]:.2f}, "
          f"spread {(rates[-1] - rates[0]) / med * 100:.2f}%; samples "
          f"{[round(r, 2) for r in rates]} [card: {smi}]")
    return med


def profile(call, what: str, smi: str) -> dict:
    """One call under torch.profiler: device idle share and the kernels
    that take the time.  Returns {kernel name: (ms, count)}, empty when
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from hetmogp_tpu_torch.ops import cuda_kernels

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        # the trace starts with an empty kernel: without one, the first
        # graph replay of a call can go unrecorded
        cuda_kernels.empty_launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        ms, n = rows.get(evt.key, (0.0, 0))
        rows[evt.key] = (ms + us / 1e3, n + evt.count)
    busy = sum(ms for ms, _ in rows.values())
    if busy <= 0:
        print(f"{what} profile: the profiler saw no device time; idle share "
              "not measured")
        return {}
    print(f"{what} profile: {busy:.3f} ms of kernel time in {wall_ms:.3f} "
          f"ms of traced wall, device idle {(1 - busy / wall_ms) * 100:.1f}% "
          f"[card: {smi}]")
    idle_gaps(prof, smi)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    for key, (ms, count) in top:
        print(f"  {ms:9.3f} ms {ms / busy * 100:5.1f}% {count:6d}x "
              f"{key[:90]} [card: {smi}]")
    return rows


def idle_gaps(prof, smi: str) -> None:
    """Where the device waits inside the traced window: the gaps between
    one device activity's end and the next one's start, summed by the
    activity that ends each gap (what the device waited for)."""
    cuda = torch.autograd.DeviceType.CUDA
    evts = sorted((e for e in prof.events() if e.device_type == cuda),
                  key=lambda e: e.time_range.start)
    if not evts:
        return
    by_next, total, end = {}, 0.0, evts[0].time_range.end
    for e in evts[1:]:
        gap = e.time_range.start - end
        if gap > 0:
            total += gap
            by_next[e.name] = by_next.get(e.name, 0.0) + gap
        end = max(end, e.time_range.end)
    span = (end - evts[0].time_range.start) / 1e3
    print(f"  gaps between device activities: {total / 1e3:.3f} ms of "
          f"{span:.3f} ms from the first to the last [card: {smi}]")
    for name, us in sorted(by_next.items(), key=lambda kv: -kv[1])[:3]:
        print(f"    {us / 1e3:8.3f} ms before {name[:80]} [card: {smi}]")


def graphed_parity_phase(smi: str):
    """Ten graphed steps at "high" against ten eager steps of the same body
    on the same offsets, and against the plain versions in f32 and f64."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

    cfg, tc, params, dataset = training_model(precision="high")
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    offsets = ttrain.draw_offset_stream(
        torch.Generator().manual_seed(SEED + 3), sizes, batches, 10)
    run = tp.make_scan_trainer(cfg, tc, sizes, batches,
                               steps_per_call=GRAPH_CALL_STEPS)
    _, graphed = run(tp.init_train_state(params, cfg), dataset,
                     offsets=offsets)
    ext = ttrain.extend_for_wraparound(dataset, batches, sizes)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    ext64 = tuple(tp.TaskData(*(a.double() for a in td)) for td in ext)
    elbos = {"graphed": graphed.double().cpu()}
    for name, c, data, p, use_kernel in (
            ("eager", cfg, ext, params, True),
            ("plain_f32", cfg, ext, params, False),
            ("plain_f64", cfg64, ext64, params.to(dtype=torch.float64),
             False)):
        step = ttrain.make_step(c, tc, use_kernel=use_kernel)
        state = tp.init_train_state(p, c)
        scales = ttrain.batch_scales(sizes, batches, c.torch_dtype, "cuda")
        out = []
        for off in offsets.tolist():
            state, metrics = step(
                state, ttrain.slice_batch(data, off, sizes, batches), scales)
            out.append(metrics["elbo"])
        elbos[name] = torch.stack(out).double().cpu()

    def rel(b, upto=None):
        r = (elbos["graphed"] - elbos[b]).abs() / elbos[b].abs()
        return float(r[:upto].max())

    first_vm = tc.ve_steps_per_vm + 1
    bitwise = torch.equal(elbos["graphed"], elbos["eager"])
    r_eager, r32_ve = rel("eager"), rel("plain_f32", first_vm)
    r32, r64 = rel("plain_f32"), rel("plain_f64")
    for name in elbos:
        print(f"  {name:9s} ELBO {elbos[name].numpy().round(3).tolist()}"
              f" [card: {smi}]")
    print(f"ten graphed steps at \"high\": vs ten eager steps {r_eager:.3e} "
          f"(bound {GRAPH_VS_EAGER:g}), bitwise equal {bitwise}; vs plain f32 "
          f"{r32_ve:.3e} up to the first VM step (bound "
          f"{GRAPH_PLAIN_F32_VE:g}), {r32:.3e} over all ten (bound "
          f"{GRAPH_PLAIN_F32:g}); vs plain f64 {r64:.3e} (bound "
          f"{GRAPH_F64:g}) [card: {smi}]")
    if not (torch.isfinite(elbos["graphed"]).all()
            and r_eager <= GRAPH_VS_EAGER
            and r32_ve <= GRAPH_PLAIN_F32_VE and r32 <= GRAPH_PLAIN_F32
            and r64 <= GRAPH_F64):
        raise AssertionError("graphed steps disagree with eager or plain")


def trajectory_ab_phase(smi: str):
    """The graphed trainer at "highest" and at "high" from one state and
    one offset stream, AB_STEPS steps each: every per-AB_EVERY mean ELBO
    within AB_TOL relative, both finite."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

    cfg, tc, params, dataset = training_model(precision="highest")
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    offsets = ttrain.draw_offset_stream(
        torch.Generator().manual_seed(SEED + 4), sizes, batches, AB_STEPS)
    means = {}
    for prec in ("highest", "high"):
        c = dataclasses.replace(cfg, ve_fwd_precision=prec)
        run = tp.make_scan_trainer(c, tc, sizes, batches,
                                   steps_per_call=GRAPH_CALL_STEPS)
        _, e = run(tp.init_train_state(params, c), dataset, offsets=offsets)
        e = e.double().cpu()
        if not torch.isfinite(e).all():
            raise AssertionError(f"trajectory at {prec!r} not finite")
        means[prec] = e.reshape(-1, AB_EVERY).mean(dim=1)
        del run
    rel = ((means["high"] - means["highest"]).abs()
           / means["highest"].abs())
    print(f"trajectory A/B, {AB_STEPS} graphed steps from one state and "
          f"offset stream, mean ELBO per {AB_EVERY} steps [card: {smi}]:")
    for i, (a, b, r) in enumerate(zip(means["highest"].tolist(),
                                      means["high"].tolist(), rel.tolist())):
        print(f"  steps {i * AB_EVERY + 1:5d}-{(i + 1) * AB_EVERY:5d}: "
              f"highest {a:.3f}, high {b:.3f}, relative {r:.3e} [card: {smi}]")
    worst = float(rel.max())
    print(f"  worst relative difference {worst:.3e} (bound {AB_TOL:g})"
          f" [card: {smi}]")
    if not worst < AB_TOL:
        raise AssertionError("high and highest trajectories disagree")


# kernel symbol -> the launchers whose launches run it: what a graphed
# call's profile must show.  Kernel 3 launches the split pre-pass;
# kernel 5 splits L in its own shared memory.  (Kernel 4's row-sum
# launch follows its "both" and "rowsum" epilogues only: no launcher count
# holds it.)
_SYMBOLS = {"rbf_cross_vec_kernel": ("rbf_K_batched_vec",),
            "rbf_cross_kernel": ("rbf_K_batched_scalar",),
            "tril_proj_tma_kernel": ("tril_projection_tma",),
            "tril_proj3_tma_kernel": ("tril_projection_3pass_tma",),
            "tril_split_bf16_kernel": ("tril_projection_3pass_tma",),
            "tril_right_tma_kernel": ("tril_right_tma",),
            "tril_right3_tma_kernel": ("tril_right3_tma",),
            "tril_out_tma_kernel": ("tril_out_tma",),
            "tril_out3_tma_kernel": ("tril_out3_tma",),
            "gh_sweep_kernel": ("gh_sweep", "gh_sweep_value"),
            "ve_tasks_kernel": ("task_var_exp", "task_var_exp_value"),
            "ve_tasks_grad_kernel": ("task_var_exp_backward",),
            "adam_kernel": ("adam_update",),
            "chol_panel_kernel": ("chol_panel",)}


def own_kernel_rows(rows: dict) -> dict:
    """{kernel symbol of _SYMBOLS: (device ms, calls)} from a profile's
    rows."""
    out = {}
    for sym in _SYMBOLS:
        pat = re.compile(rf"(?<![A-Za-z_]){sym}(?![a-z0-9_])")
        hits = [v for key, v in rows.items() if pat.search(key)]
        out[sym] = (sum(ms for ms, _ in hits), sum(n for _, n in hits))
    return out


def graphed_trainer_phase(smi: str, precision: str,
                          timed_calls=GRAPH_CALLS):
    """The main path at ``precision``: a fresh make_scan_trainer with the
    launch counts from 0 around its first call (capture and 1,000 steps),
    steps/s over ``timed_calls`` calls, the ELBO, peak memory, and a
    profile of a PROFILE_STEPS-step call of the same graphs.  Returns the
    launch counts of the first call and the kernel launches its replays
    made."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    cfg, tc, params, dataset = training_model(precision=precision)
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    gen = torch.Generator().manual_seed(SEED + 2)
    what = f"graphed trainer (make_scan_trainer, \"{precision}\")"

    ck.zero_launch_counts()
    run = tp.make_scan_trainer(cfg, tc, sizes, batches,
                               steps_per_call=GRAPH_CALL_STEPS)
    t0 = time.perf_counter()
    state, first = run(tp.init_train_state(params, cfg), dataset, gen)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counts = ck.launch_counts()
    replayed = {k: sum(run.capture_launches[kind][k] * run.replays[kind]
                       for kind in run.graphs) for k in counts}
    print(f"{what}, first call of {GRAPH_CALL_STEPS} steps: {warm:.3f} s, "
          f"of which warm-up and capture {run.capture_seconds:.3f} s; "
          f"launches counted from 0 (warm-up and capture) {counts}; "
          f"launches per graph {run.capture_launches}; replays "
          f"{run.replays}; kernel launches by the replays {replayed} "
          f"[card: {smi}]")
    n_vm = run.replays["vm"]
    high = precision == "high"
    # a step: the RBF kernel, the projection (kernel 3 at "high" in the VE
    # step, kernel A in the VM step's solve_tri_cached and at "highest"),
    # quad_diag (kernel 4, "both"), and kernel 8 once (quad_diag's gL in a
    # VE step, the solve's Lbar in the VM step; 3-pass at "high"); the VM
    # step adds kernel A for quad_diag's gA, its four adjoint products
    # (kernel 5 at "high", kernel 4 at "highest") and the refresh of
    # (Luu, iLuu): kernel 9 on each diagonal panel, kernel A on the rows
    # below each panel and kernel 4 on each of the inverse's row strips
    want = {"rbf_K_batched_vec": GRAPH_CALL_STEPS, "rbf_backward": n_vm,
            "rbf_K_batched_scalar": 0,
            "tril_projection_tma": (2 * n_vm if high
                                    else GRAPH_CALL_STEPS + n_vm)
            + REFRESH_BELOW * n_vm,
            "tril_projection_3pass_tma": (GRAPH_CALL_STEPS - n_vm
                                          if high else 0),
            "tril_right_tma": (GRAPH_CALL_STEPS + (0 if high else 4 * n_vm)
                               + REFRESH_STRIPS * n_vm),
            "tril_right3_tma": 4 * n_vm if high else 0,
            "tril_out3_tma": GRAPH_CALL_STEPS if high else 0,
            "tril_out_tma": 0 if high else GRAPH_CALL_STEPS,
            # kernel 6's task table for the six tasks' likelihood term,
            # forward and backward, and kernel 7 once, every step; no
            # per-engine sweep
            "task_var_exp": GRAPH_CALL_STEPS,
            "task_var_exp_backward": GRAPH_CALL_STEPS,
            "task_var_exp_value": 0, "gh_sweep": 0, "gh_sweep_value": 0,
            "adam_update": GRAPH_CALL_STEPS,
            "chol_panel": REFRESH_PANELS * n_vm}
    if replayed != want or any(counts[k] < 1 for k in want if want[k]):
        raise AssertionError(f"the graphs did not run the kernels: {replayed}"
                             f" replayed, {want} expected")

    calls, rates, host = [first], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(timed_calls):
        t0 = time.perf_counter()
        state, e = run(state, dataset, gen)
        t1 = time.perf_counter()  # the host has enqueued every replay
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rates.append(GRAPH_CALL_STEPS / (t2 - t0))
        host.append((t1 - t0) / (t2 - t0))
        calls.append(e)
    med = report_rates(what, rates, GRAPH_CALL_STEPS, smi)
    # near 1: the host's replay loop, not the device, sets the pace
    print(f"{what}: share of a call's wall time until the host has "
          f"enqueued its last replay, median {statistics.median(host):.4f} "
          f"(min {min(host):.4f}, max {max(host):.4f}) [card: {smi}]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    e = torch.cat(calls).double().cpu()
    start, end = float(e[:10].mean()), float(e[-10:].mean())
    print(f"{what}: ELBO over {e.numel()} steps, mean of the first ten "
          f"{start:.3f}, of the last ten {end:.3f}, final "
          f"{float(e[-1]):.3f}; peak memory {peak:.2f} GiB [card: {smi}]")
    if not (torch.isfinite(e).all() and end > start):
        raise AssertionError("ELBO not finite or not rising")

    offsets = ttrain.draw_offset_stream(gen, sizes, batches, PROFILE_STEPS)
    rows = profile_replays(run, lambda: run(state, dataset, offsets=offsets),
                           f"{what}, one call of {PROFILE_STEPS} steps", smi)
    # the refresh is the blocked pair: no cuSOLVER factor, no triangular
    # solve runs in the graphs
    library = sorted(k for k in rows if re.search(r"potrf|trsm", k))
    print(f"{what}: cuSOLVER potrf and trsm kernels in the profile: "
          f"{library or 'none'} [card: {smi}]")
    if library:
        raise AssertionError(f"the graphs ran {library}")
    return counts, replayed, med


def profile_replays(run, call, what: str, smi: str) -> dict:
    """Profile ``call``, a call of the trainer ``run``'s graphs, and hold
    the calls of each hand kernel in the trace to the launches that its
    replays hold.

    The profiler can lose device records of graph replays: in such a trace
    the library's kernels and ours alike show a few calls fewer than the
    replays launched, at random.  A kernel that the graphs lack is missing
    from every trace, and more calls than launches is never a loss, so the
    check fails on more calls at once, takes a trace with fewer again, up
    to PROFILE_TRIES traces of the same call, and fails unless one of them
    shows every kernel's calls exactly.  Returns that trace's rows (empty
    where the profiler saw no device time)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        before = dict(run.replays)
        rows = profile(call, what, smi)
        if not rows:
            return rows
        steps = {k: run.replays[k] - before[k] for k in run.replays}
        short = {}
        for sym, (ms, seen) in own_kernel_rows(rows).items():
            per_graph = sum(run.capture_launches[kind][launcher]
                            * steps[kind]
                            for kind in steps for launcher in _SYMBOLS[sym])
            print(f"  {sym}: {seen} calls in the profile, {per_graph} "
                  f"expected from the replays; device time {ms:.3f} ms"
                  f"{f', {ms / seen:.4f} ms a call' if seen else ''} "
                  f"[card: {smi}]")
            if seen > per_graph:
                raise AssertionError(f"the profile shows {seen} calls of "
                                     f"{sym}, the replays {per_graph}")
            if seen < per_graph:
                short[sym] = (seen, per_graph)
        if not short:
            return rows
        print(f"{what}: trace {attempt} of {PROFILE_TRIES} lost device "
              f"records, (calls in the profile, launches by the replays) "
              f"{short} [card: {smi}]")
    raise AssertionError(f"the profile shows fewer calls than the replays "
                         f"launched in each of {PROFILE_TRIES} traces, in "
                         f"the last {short}")


def serving_model(device="cuda", m=M, q=Q):
    """The bench serving model, with random weights from SEED: six
    likelihoods, Z ~ U[0,1)^(M x 2), lengthscale 0.2, variance 0.5,
    q_mu = 0.1 N(0,1), and a non-identity q_sqrt (with the identity the
    variance term quad_diag(P, I) - |P|^2 cancels to zero)."""
    import hetmogp_tpu_torch as tp

    liks = (tp.HetGaussian(), tp.Bernoulli(), tp.Categorical(K=3),
            tp.Poisson(), tp.Gamma(), tp.Exponential())
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=q, num_inducing=m,
                         input_dim=DX, dtype="float32", jitter=1e-4,
                         adaptive_jitter=False)
    rng = np.random.default_rng(SEED)
    params = tp.init_params(rng, cfg, rng.random((m, DX)), lengthscale=0.2,
                            variance=0.5, q_mu_scale=0.1, device=device)
    q_sqrt = 0.5 * np.eye(m) + 0.01 * np.tril(rng.standard_normal((q, m, m)))
    params = dataclasses.replace(params, q_sqrt=torch.tensor(
        q_sqrt, dtype=torch.float32, device=device))
    X = torch.tensor(rng.random((N_CHUNKS * CHUNK, DX)), dtype=torch.float32,
                     device=device)
    return cfg, params, X


def normwise(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def serving_phase(smi: str, device="cuda", m=M, q=Q) -> dict:
    """The bench serving model at full width: launches, moments against
    plain f32 and f64, rows/s and a profile.  Returns the launches of one
    serving pass."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.ops import cuda_kernels

    cfg, params, X = serving_model(device, m, q)
    serve = [tp.make_serving_predictive(params, cfg, t)
             for t in range(cfg.num_tasks)]
    chunks = X.split(CHUNK)

    def serve_all():
        return [serve[t](Xc) for t in range(cfg.num_tasks) for Xc in chunks]

    _zero_counts()
    out = serve_all()
    torch.cuda.synchronize()
    tril, launches, *_ = _counts()
    per_pass = cuda_kernels.launch_counts()
    rows = cfg.num_tasks * X.shape[0]
    print(f"serving pass: {rows} rows, {len(out)} chunk requests, "
          f"rbf kernel launches {launches}, projection kernel launches "
          f"{tril}; launches per serving pass by launcher {per_pass} "
          f"[card: {smi}]")
    # quad_diag under inference_mode: kernel 4's row sums alone, a request
    if (launches < len(out) or tril < len(out)
            or per_pass["tril_right_tma"] != len(out)):
        raise AssertionError("the serving pass did not go through the "
                             "kernels")
    for i, (mean, var) in enumerate(out):
        t = i // len(chunks)
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            raise AssertionError(f"task {t}: non-finite moments")
        if not bool((var >= 0).all()):
            raise AssertionError(f"task {t}: negative variance")
        if t in (1, 2) and not bool(((mean > 0) & (mean < 1)).all()):
            raise AssertionError(f"task {t}: probability mean outside (0, 1)")

    # one chunk against the same path with the plain RBF, f32 and f64
    Xs = X[:ACC_ROWS]
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    params64 = params.to(dtype=torch.float64)
    worst = {"plain_f32": 0.0, "f64": 0.0}
    for t, lik in enumerate(cfg.likelihoods):
        got = serve[t](Xs)
        ref32 = tp.make_serving_predictive(params, cfg, t,
                                           use_kernel=False)(Xs)
        ref64 = tp.make_serving_predictive(params64, cfg64, t,
                                           use_kernel=False)(Xs.double())
        e32 = [normwise(a, b) for a, b in zip(got, ref32)]
        e64 = [normwise(a, b) for a, b in zip(got, ref64)]
        print(f"task {t} {type(lik).__name__}: normwise error (mean, var) "
              f"vs plain f32 {e32[0]:.3e}, {e32[1]:.3e}; "
              f"vs f64 {e64[0]:.3e}, {e64[1]:.3e} [card: {smi}]")
        worst["plain_f32"] = max(worst["plain_f32"], *e32)
        worst["f64"] = max(worst["f64"], *e64)
    if not worst["plain_f32"] <= PLAIN_F32_BOUND:
        raise AssertionError(f"served moments vs plain f32: {worst}")
    if not worst["f64"] <= F64_BOUND:
        raise AssertionError(f"served moments vs f64: {worst}")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        serve_all()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rates = sorted(rows / dt for dt in times)
    med = statistics.median(rates)
    print(f"serving throughput: {med:.1f} rows/s, median of 5 passes of "
          f"{rows} rows, min {rates[0]:.1f}, max {rates[-1]:.1f}, spread "
          f"{(rates[-1] - rates[0]) / med * 100:.2f}% [card: {smi}]")
    prof = profile(serve_all, "serving pass", smi)
    for sym, (ms, calls) in own_kernel_rows(prof).items():
        if calls:
            print(f"  {sym}: {calls} calls in the serving pass, device time "
                  f"{ms:.3f} ms, {ms / calls:.4f} ms a call [card: {smi}]")
    return per_pass


# The prediction entries at full width, each against the same call in
# float64 and with the plain versions (use_kernel=False), normwise.
# Marginal moments and means: the serving path's bounds and reasons (Kfu's
# rounding through a factor with entries ~1e2; float32 projection ~2.3e-4
# and a digit of cancellation).  Full covariances the same, over max|cov|:
# Kxx + (P Lq)(P Lq)^T - P P^T cancels as the marginal variance does.
# Samples mu + eps L^T: L factorizes a covariance that is singular to
# float32, so its last pivots sit at the adaptive jitter level and single
# samples are not comparable across precisions.  What is: the covariance
# L L^T that the sampler draws with (identity draws return L^T), against
# the float64 sampler's.  jitchol adds at most mean(diag) * 1e-2 (its
# fifth level) to a diagonal of order max|cov|, on top of the full
# covariance's own error: 2e-2 on both sides.  The projected path solves
# against the (N, N) prior Gram of the anchor at the config's jitter 1e-4,
# ill-conditioned beyond float32; but the solve's error lies in the
# directions of the small eigenvalues, which Kx damps again, so its mean
# and variance hold the served moments' bound, 1e-2, on both sides.  NLPD
# sums 24,576 logsumexp rows of the marginal moments, whose errors average
# out: 1e-3 relative.
PRED_ROWS = 4096
PRED_SAMPLES = 1000
SAMPLE_COV_BOUND = 2e-2
PROJECTED_BOUND = 1e-2
NLPD_BOUND = 1e-3


def prediction_phase(smi: str):
    """The rest of the prediction API on the serving model at full width:
    every entry runs through the RBF kernel (the counts say which route),
    is checked against float64 and the plain route, and is timed."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    cfg, params, X = serving_model()
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    params64 = params.to(dtype=torch.float64)
    Xs = X[:PRED_ROWS]
    anchor = X[CHUNK:CHUNK + PROJECTED_ANCHOR]
    rng = np.random.RandomState(SEED + 7)
    n = PRED_ROWS
    Y = [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
         rng.randint(1, 4, (n, 1)).astype(float),
         rng.poisson(3.0, (n, 1)).astype(float),
         rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
         rng.exponential(1.0, (n, 1)) + 1e-3]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    eps_nlpd = [torch.randn(n, PRED_SAMPLES, lik.dim_f, generator=gen,
                            device="cuda") for lik in cfg.likelihoods]
    X_tasks = [Xs] * cfg.num_tasks

    def run(what, call, bounds, route="rbf_K_batched_vec", check=None):
        """``call(params, cfg, X-cast, **kw)`` with the kernels (timed, the
        counts from 0), with the plain versions, and in float64."""
        call(params, cfg, lambda x: x)  # warm: allocator, cuSOLVER handles
        torch.cuda.synchronize()
        ck.zero_launch_counts()
        t0 = time.perf_counter()
        got = call(params, cfg, lambda x: x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        ref32 = call(params, cfg, lambda x: x, use_kernel=False)
        ref64 = call(params64, cfg64, lambda x: x.double(), use_kernel=False)
        worst32 = max(normwise(a, b) for a, b in zip(got, ref32))
        worst64 = max(normwise(a, b) for a, b in zip(got, ref64))
        print(f"prediction, {what}: {ms:.3f} ms; launches {counts}; worst "
              f"normwise error vs the plain route {worst32:.3e} (bound "
              f"{bounds[0]:g}), vs float64 {worst64:.3e} (bound "
              f"{bounds[1]:g}) [card: {smi}]")
        if not all(bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"{what}: non-finite")
        if counts.get(route, 0) < 1:
            raise AssertionError(f"{what} did not run {route}: {counts}")
        if not (worst32 <= bounds[0] and worst64 <= bounds[1]):
            raise AssertionError(f"{what} out of bounds")
        if check is not None:
            check(got)
        return got

    serve_bounds = (PLAIN_F32_BOUND, F64_BOUND)

    def variances_ok(variances):
        if not all(bool((v >= 0).all()) for v in variances):
            raise AssertionError("negative variance")

    mean_u, var_u = run(
        f"predict_latent_u ({PRED_ROWS} rows)",
        lambda p, c, cast, **kw: tp.predict_latent_u(p, c, cast(Xs), **kw),
        serve_bounds)

    def diag_is_marginal(what, cov, var):
        d = torch.diagonal(cov, dim1=-2, dim2=-1)
        err = normwise(d, var)
        print(f"  {what}: diag(full cov) vs the marginal variance "
              f"{err:.3e} (bound {PLAIN_F32_BOUND:g}); min diag "
              f"{float(d.min()):.3e}; max asymmetry "
              f"{float((cov - cov.mT).abs().max()):.3e} [card: {smi}]")
        if not err <= PLAIN_F32_BOUND:
            raise AssertionError(f"{what}: diag(cov) is not the variance")

    run(f"predict_latent_u (full_cov, {PRED_ROWS} rows)",
        lambda p, c, cast, **kw: tp.predict_latent_u(p, c, cast(Xs),
                                                     full_cov=True, **kw),
        serve_bounds,
        check=lambda got: diag_is_marginal("latent u", got[1], var_u.mT))
    d = 2  # Bernoulli's function
    _, var_f = tp.predict_f(params, cfg, Xs, d)
    if not bool((var_f >= 0).all() and (var_u >= 0).all()):
        raise AssertionError("negative marginal variance")
    run(f"predict_f (full_cov, {PRED_ROWS} rows)",
        lambda p, c, cast, **kw: tp.predict_f(p, c, cast(Xs), d,
                                              full_cov=True, **kw),
        serve_bounds,
        check=lambda got: diag_is_marginal("f_d", got[1], var_f))
    eye = torch.eye(PRED_ROWS, device="cuda")

    def sampler_cov(p, c, cast, **kw):
        """L L^T of the factor sample_f draws with: identity draws give
        S - mu = L^T."""
        S = tp.sample_f(p, c, None, cast(Xs), d, num_samples=PRED_ROWS,
                        eps=cast(eye), **kw)
        Lt = S - tp.predict_f(p, c, cast(Xs), d, **kw)[0][None]
        return (Lt.mT @ Lt,)

    run(f"sample_f (identity draws, {PRED_ROWS} rows: the sampler's "
        "covariance)", sampler_cov, (SAMPLE_COV_BOUND, SAMPLE_COV_BOUND))
    del eye
    t0 = time.perf_counter()
    drawn = tp.sample_f(params, cfg, gen, Xs, d, num_samples=8)
    torch.cuda.synchronize()
    print(f"prediction, sample_f (8 samples from a generator, {PRED_ROWS} "
          f"rows): {(time.perf_counter() - t0) * 1e3:.3f} ms; sample "
          f"standard deviation over rows {float(drawn.std(dim=1).mean()):.4f}"
          f" [card: {smi}]")
    if not (drawn.shape == (8, PRED_ROWS) and bool(torch.isfinite(
            drawn).all())):
        raise AssertionError("sample_f from a generator: bad samples")

    for ns, route in ((PROJECTED_NS, "rbf_K_batched_vec"),
                      (PROJECTED_NS - 1, "rbf_K_batched_scalar")):
        run(f"predict_f_projected_task (anchor {PROJECTED_ANCHOR}, Ns {ns})",
            lambda p, c, cast, **kw: tp.predict_f_projected_task(
                p, c, [cast(anchor)], cast(X[:ns]), 0, **kw),
            (PROJECTED_BOUND, PROJECTED_BOUND), route=route,
            check=lambda got: variances_ok(got[1:]))

    def flat(pair):
        return [t for part in pair for t in part]

    run(f"predictive (solve path, {cfg.num_tasks} x {PRED_ROWS} rows)",
        lambda p, c, cast, **kw: flat(tp.predictive(
            p, c, [cast(x) for x in X_tasks], **kw)),
        serve_bounds,
        check=lambda got: variances_ok(got[cfg.num_tasks:]))
    run(f"negative_log_predictive ({PRED_SAMPLES} samples, "
        f"{cfg.num_tasks} x {PRED_ROWS} rows)",
        lambda p, c, cast, **kw: (tp.negative_log_predictive(
            p, c, None, [cast(x) for x in X_tasks], Y,
            num_samples=PRED_SAMPLES, eps=[cast(e) for e in eps_nlpd],
            **kw),),
        (NLPD_BOUND, NLPD_BOUND))
    nlpd = tp.negative_log_predictive(params, cfg, gen, X_tasks, Y,
                                      num_samples=PRED_SAMPLES)
    if not bool(torch.isfinite(nlpd)):
        raise AssertionError("NLPD from a generator: not finite")
    print(f"prediction, NLPD with the generator's draws: {float(nlpd):.6f} "
          f"(reference scaling) [card: {smi}]")
    del eps_nlpd
    torch.cuda.empty_cache()


def ragged_serving_phase(smi: str) -> dict:
    """The padded path: the serving model at RAGGED_M inducing points,
    which the triangular products' routers pad to M % 4 == 0 for their TMA
    designs (quad_diag's kernel 4 too), at "highest" (kernel A) and "high"
    (kernel 3): an
    ACC_ROWS-row chunk of each task with the counts from 0, checked
    against the same path with the plain versions.  Returns the launch
    counts of both passes together."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    cfg, params, X = serving_model(m=RAGGED_M)
    Xs = X[:ACC_ROWS]
    total = {}
    for prec, proj, other, bound in (
            ("highest", "tril_projection_tma", "tril_projection_3pass_tma",
             PLAIN_F32_BOUND),
            ("high", "tril_projection_3pass_tma", "tril_projection_tma",
             RAGGED_HIGH_BOUND)):
        c = dataclasses.replace(cfg, ve_fwd_precision=prec)
        # the serving functions first: their cache's blocked factorization
        # runs kernels 9, A and 4 on its 128-wide panels (aligned), which
        # are not the requests' launches
        serve = [tp.make_serving_predictive(params, c, t)
                 for t in range(c.num_tasks)]
        ck.zero_launch_counts()
        got = [f(Xs) for f in serve]
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        worst = 0.0
        for t, moments in enumerate(got):
            ref = tp.make_serving_predictive(params, c, t,
                                             use_kernel=False)(Xs)
            if not all(torch.isfinite(a).all() for a in moments):
                raise AssertionError(f"ragged serving, task {t}: non-finite")
            worst = max(worst, *(normwise(a, b) for a, b in zip(moments,
                                                                 ref)))
        print(f"ragged serving (M={RAGGED_M}, \"{prec}\"), {c.num_tasks} "
              f"chunks of {ACC_ROWS} rows: launches {counts}; worst normwise "
              f"error of the moments vs plain f32 {worst:.3e} (bound "
              f"{bound:g}) [card: {smi}]")
        # quad_diag: kernel 4, a request
        if (counts[proj] < c.num_tasks or counts[other]
                or not worst <= bound
                or counts["tril_right_tma"] != c.num_tasks
                or counts["rbf_K_batched_scalar"] < c.num_tasks
                or counts["rbf_K_batched_vec"]):
            raise AssertionError(f"ragged serving at {prec!r} did not go "
                                 f"through {proj} padded, or disagrees")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# The ten-family model (families_phase): the flagship's width with the
# ten families that the six bench ones leave, each trainable theta set
# away from its truth so that training has to move it.
FAMILY_N_PER = 100_000  # 1.0e6 rows over ten tasks, as the flagship has
FAMILY_SAMPLES = 1000  # NLPD draws a row


def families_true_likelihoods():
    """The ten families with the parameters the data is drawn from."""
    import hetmogp_tpu_torch as tp

    return (tp.Gaussian(sigma=0.3), tp.Beta(), tp.Binomial(n=10),
            tp.Dirichlet(K=3), tp.LogNormal(sigma=0.3),
            tp.Ordinal(K=4, thresholds=(-1.2, 0.1, 0.9)),
            tp.NegativeBinomial(r=5.0), tp.StudentT(df=8.0),
            tp.Weibull(k=1.8), tp.ZeroInflatedPoisson())


# the true parameter functions f_d(x) = c_d + a_d sin(2 pi w_d . x + phi_d),
# (c_d, a_d) per column in task order: Beta's and Dirichlet's
# concentrations e^f stay in [1.5, 5] (no draw rounds to 0 or 1 in
# float32), the counts' rates and the Ordinal's f within the data's scale
FAMILY_F_SHAPE = ((0.0, 1.0), (1.0, 0.4), (1.0, 0.4), (0.0, 0.8),
                  (1.0, 0.4), (1.0, 0.4), (1.0, 0.4), (0.0, 0.5),
                  (0.0, 1.5), (1.0, 0.5), (0.0, 1.0), (-1.0, 0.2),
                  (0.0, 0.5), (1.0, 0.5), (-0.5, 0.5))


def families_model(device="cuda"):
    """The flagship's model and trainer (bench.py:172-217: Q=4, M=1024,
    Dx=2, 1.0e6 rows, B=512 a task, float32, jitter 1e-4, adam at 0.005,
    slice minibatches, vm_batch_fraction 0.25, "high") with the ten other
    families and ``learn_lik_params``: X from RandomState(SEED), Y drawn by
    ``HetLikelihood.samples`` from a seeded CPU generator at the true f
    and the true theta; the initial theta are the families' defaults
    (sigma 0.5, r 2, df 4, k 1.0, evenly spaced thresholds)."""
    import hetmogp_tpu_torch as tp

    liks = (tp.Gaussian(learn_sigma=True), tp.Beta(), tp.Binomial(n=10),
            tp.Dirichlet(K=3), tp.LogNormal(learn_sigma=True),
            tp.Ordinal(K=4), tp.NegativeBinomial(learn_r=True),
            tp.StudentT(learn_df=True), tp.Weibull(k=1.0, learn_k=True),
            tp.ZeroInflatedPoisson())
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                         input_dim=DX, dtype="float32", jitter=1e-4,
                         adaptive_jitter=False, fuse_task_rows=True,
                         ve_fwd_precision="high")
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.005, minibatch="slice",
                        vm_batch_fraction=0.25, learn_lik_params=True)
    rng = np.random.RandomState(SEED)
    X_list = [rng.rand(FAMILY_N_PER, DX).astype(np.float32) for _ in liks]
    w = 2.0 * rng.rand(cfg.num_output_functions, DX)
    phi = 2.0 * np.pi * rng.rand(cfg.num_output_functions)
    F = []
    for t, (start, stop) in enumerate(cfg.task_function_slices):
        cols = [FAMILY_F_SHAPE[d][0] + FAMILY_F_SHAPE[d][1] * np.sin(
            2.0 * np.pi * X_list[t] @ w[d] + phi[d])
            for d in range(start, stop)]
        F.append(torch.from_numpy(np.stack(cols, axis=1)))
    truth = tp.HetLikelihood(families_true_likelihoods())
    Y_list = [y.numpy().astype(np.float32) for y in truth.samples(
        torch.Generator().manual_seed(SEED + 9), F)]
    Z = rng.rand(M, DX).astype(np.float32)
    params = tp.init_params(rng, cfg, Z, lengthscale=0.2, variance=0.5,
                            q_mu_scale=0.1, with_lik_theta=True,
                            device=device)
    dataset = tp.prepare_dataset_on_device(cfg, X_list, Y_list, device=device)
    return cfg, tc, params, dataset, X_list, Y_list


def natural_theta(lik, theta) -> list:
    """A learned theta in the family's own units: sigma, r, df, k, or the
    Ordinal's thresholds."""
    return [round(float(x), 4) for x in
            (lik.with_theta(theta).thresholds if hasattr(lik, "thresholds")
             else torch.exp(theta.detach().double().cpu()))]


def families_phase(smi: str, device="cuda") -> dict:
    """The ten other likelihood families, trained with their theta through
    the graphed trainer and served, at the flagship's width:

    1. ten graphed steps from the initial state against ten eager steps
       (bitwise, ELBO and every parameter, theta included) and against the
       plain versions in float32 and float64 (the flagship's bounds);
    2. two timed calls of GRAPH_CALL_STEPS graphed steps: steps/s, capture
       time, peak memory, the hand kernels' launches per 5-step cycle, a
       rising ELBO, a profile of a PROFILE_STEPS-step call, and every
       learned theta finite and moved;
    3. serving through ``make_serving_predictive`` on
       ``config.with_trained_likelihoods(params)`` (at "highest", the
       serving cell's precision): ten tasks x CHUNK rows, rows/s; ACC_ROWS
       rows of each task against the plain float32 route and float64; the
       moments finite, variances non-negative, Binomial and Ordinal
       probabilities in [0, 1], Dirichlet means on the simplex;
    4. NLPD of the ten tasks on ACC_ROWS rows against float64, on the
       generator's draws.

    5. the trained model's ELBO on one minibatch without a gradient
       (``predict.elbo_evaluator``) against the plain versions.

    The launch counts go to 0 just before the first call and are read just
    after it, and again around 5.  Returns both."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch import profiling
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    cfg, tc, params, dataset, X_list, Y_list = families_model(device)
    T = cfg.num_tasks
    sizes, batches = (FAMILY_N_PER,) * T, (TRAIN_B,) * T
    what = ("ten-family trainer (make_scan_trainer, \"high\", "
            "learn_lik_params)")
    names = ", ".join(type(lik).__name__ for lik in cfg.likelihoods)
    print(f"{what}: {T} tasks ({names}), D={cfg.num_output_functions}, "
          f"{T * FAMILY_N_PER} rows, data made in "
          f"{time.perf_counter() - t_phase:.3f} s [card: {smi}]")

    # 1. ten graphed steps against eager and plain
    offsets = ttrain.draw_offset_stream(
        torch.Generator().manual_seed(SEED + 10), sizes, batches, 10)
    run = tp.make_scan_trainer(cfg, tc, sizes, batches,
                               steps_per_call=GRAPH_CALL_STEPS)
    ck.zero_launch_counts()
    t0 = time.perf_counter()
    state, graphed = run(tp.init_train_state(params, cfg), dataset,
                         offsets=offsets)
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    counts = ck.launch_counts()
    cycle = {k: sum(run.capture_launches[kind][k]
                    * (tc.ve_steps_per_vm if kind == "ve" else 1)
                    for kind in run.graphs) for k in counts}
    print(f"{what}, first call of 10 steps: {first_call:.3f} s, of which "
          f"warm-up and capture {run.capture_seconds:.3f} s; launches "
          f"counted from 0 {counts}; launches per graph "
          f"{run.capture_launches}; per 5-step cycle: rbf "
          f"{cycle['rbf_K_batched_vec']}, kernel 3 "
          f"{cycle['tril_projection_3pass_tma']}, kernel A "
          f"{cycle['tril_projection_tma']}, kernel 4 "
          f"{cycle['tril_right_tma']}, kernel 5 {cycle['tril_right3_tma']}"
          f" [card: {smi}]")
    # the flagship's cycle at "high" (graphed_trainer_phase), the refresh's
    # launches of kernels 9, A and 4 included
    want = {"rbf_K_batched_vec": 5, "tril_projection_3pass_tma": 4,
            "tril_projection_tma": 2 + REFRESH_BELOW,
            "tril_right_tma": 5 + REFRESH_STRIPS, "tril_right3_tma": 4,
            "chol_panel": REFRESH_PANELS,
            "tril_out3_tma": 5, "tril_out_tma": 0,
            "rbf_K_batched_scalar": 0,
            # Beta, Binomial, Dirichlet and the ZIP on kernel 6's task
            # table (a forward and a backward launch a step; no per-engine
            # sweep), the six theta families on their engines, and kernel
            # 7, every step
            "gh_sweep": 0, "task_var_exp": 5, "task_var_exp_backward": 5,
            "adam_update": 5}
    if ({k: cycle[k] for k in want} != want
            or any(counts[k] < 1 for k in want if want[k])):
        raise AssertionError(f"the ten-family graphs did not run the "
                             f"kernels: {cycle} a cycle, {want} expected")
    # the likelihood term's tasks, counted at the capture of each graph
    routed = {kind: c["elbo.likelihood"]["counts"]
              for kind, c in profiling.graph_counters().items()
              if "elbo.likelihood" in c}
    print(f"{what}: likelihood term's tasks by graph (table / own engine) "
          f"{routed} [card: {smi}]")
    if any(c != {"likelihood.table_tasks": 4, "likelihood.engine_tasks": 6}
           for c in routed.values()) or not routed:
        raise AssertionError(f"the ten-family likelihood term did not send "
                             f"4 tasks to the table and 6 to their engines: "
                             f"{routed}")
    ext = ttrain.extend_for_wraparound(dataset, batches, sizes)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    ext64 = tuple(tp.TaskData(*(a.double() for a in td)) for td in ext)
    elbos = {"graphed": graphed.double().cpu()}
    for name, c, data, p, use_kernel in (
            ("eager", cfg, ext, params, True),
            ("plain_f32", cfg, ext, params, False),
            ("plain_f64", cfg64, ext64, params.to(dtype=torch.float64),
             False)):
        step = ttrain.make_step(c, tc, use_kernel=use_kernel)
        s = tp.init_train_state(p, c)
        scales = ttrain.batch_scales(sizes, batches, c.torch_dtype, device)
        out = []
        for off in offsets.tolist():
            s, metrics = step(s, ttrain.slice_batch(data, off, sizes,
                                                    batches), scales)
            out.append(metrics["elbo"])
        elbos[name] = torch.stack(out).double().cpu()
        if name == "eager":
            eager_state = s
    from hetmogp_tpu_torch.models.params import leaves
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves(state.params), leaves(eager_state.params)))
    bitwise = torch.equal(elbos["graphed"], elbos["eager"])

    def rel(b, upto=None):
        r = (elbos["graphed"] - elbos[b]).abs() / elbos[b].abs()
        return float(r[:upto].max())

    first_vm = tc.ve_steps_per_vm + 1
    r32_ve, r32, r64 = (rel("plain_f32", first_vm), rel("plain_f32"),
                        rel("plain_f64"))
    for name in elbos:
        print(f"  {name:9s} ELBO {elbos[name].numpy().round(3).tolist()}"
              f" [card: {smi}]")
    print(f"{what}, ten graphed steps: bitwise equal to ten eager steps: "
          f"ELBO {bitwise}, every parameter with theta {same_params}; vs "
          f"plain f32 {r32_ve:.3e} up to the first VM step (bound "
          f"{GRAPH_PLAIN_F32_VE:g}), {r32:.3e} over all ten (bound "
          f"{GRAPH_PLAIN_F32:g}); vs plain f64 {r64:.3e} (bound "
          f"{GRAPH_F64:g}) [card: {smi}]")
    if not (bitwise and same_params and torch.isfinite(elbos["graphed"]).all()
            and r32_ve <= GRAPH_PLAIN_F32_VE and r32 <= GRAPH_PLAIN_F32
            and r64 <= GRAPH_F64):
        raise AssertionError("ten-family graphed steps disagree with eager "
                             "or plain")
    del ext, ext64, eager_state

    # 2. two timed calls
    gen = torch.Generator().manual_seed(SEED + 11)
    calls, rates = [graphed], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        state, e = run(state, dataset, gen)
        torch.cuda.synchronize()
        rates.append(GRAPH_CALL_STEPS / (time.perf_counter() - t0))
        calls.append(e)
    report_rates(what, rates, GRAPH_CALL_STEPS, smi)
    peak = torch.cuda.max_memory_allocated() / 2**30
    e = torch.cat(calls).double().cpu()
    start, end = float(e[:10].mean()), float(e[-10:].mean())
    print(f"{what}: ELBO over {e.numel()} steps, mean of the first ten "
          f"{start:.3f}, of the last ten {end:.3f}; peak memory "
          f"{peak:.2f} GiB; capture {run.capture_seconds:.3f} s "
          f"[card: {smi}]")
    if not (torch.isfinite(e).all() and end > start):
        raise AssertionError("ten-family ELBO not finite or not rising")
    held = {}
    offsets = ttrain.draw_offset_stream(gen, sizes, batches, PROFILE_STEPS)
    profile_replays(run, lambda: held.update(
        out=run(state, dataset, offsets=offsets)),
        f"{what}, one call of {PROFILE_STEPS} steps", smi)
    state = held["out"][0]
    truth = families_true_likelihoods()
    for t, lik in enumerate(cfg.likelihoods):
        if not lik.n_theta:
            continue
        new, old = state.params.lik_theta[t], params.lik_theta[t]
        true = torch.from_numpy(truth[t].default_theta())
        print(f"  {type(lik).__name__} theta: start "
              f"{natural_theta(lik, old)}, learned {natural_theta(lik, new)}"
              f", truth {natural_theta(lik, true)} [card: {smi}]")
        if not (torch.isfinite(new).all() and not torch.equal(new, old)):
            raise AssertionError(f"task {t}: theta not finite or not moved")
    trained = state.params

    # 3. serving the trained model
    serve_cfg = dataclasses.replace(cfg.with_trained_likelihoods(trained),
                                    ve_fwd_precision="highest")
    student = serve_cfg.likelihoods[7]
    if not student.df > 2.0:
        raise AssertionError(f"learned df {student.df} <= 2")
    Xs = torch.tensor(np.random.RandomState(SEED + 12).rand(CHUNK, DX),
                      dtype=torch.float32, device=device)
    serve = [tp.make_serving_predictive(trained, serve_cfg, t)
             for t in range(T)]

    def serve_all():
        return [serve[t](Xs) for t in range(T)]

    ck.zero_launch_counts()
    out = serve_all()
    torch.cuda.synchronize()
    served = {k: v for k, v in ck.launch_counts().items() if v}
    print(f"ten-family serving pass: {T} x {CHUNK} rows; launches {served}"
          f" [card: {smi}]")
    if (served.get("rbf_K_batched_vec", 0) < T
            or served.get("tril_projection_tma", 0) < T
            or served.get("tril_right_tma", 0) != T):
        raise AssertionError("ten-family serving did not run the kernels")
    for t, (lik, (mean, var)) in enumerate(zip(serve_cfg.likelihoods, out)):
        name = type(lik).__name__
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()
                and bool((var >= 0).all())):
            raise AssertionError(f"task {t} {name}: non-finite moments or a "
                                 "negative variance")
        if name == "Binomial":
            mean = mean / lik.n
        if name in ("Binomial", "Ordinal") and not bool(
                ((mean >= 0) & (mean <= 1)).all()):
            raise AssertionError(f"task {t} {name}: probability outside "
                                 "[0, 1]")
        if name == "Dirichlet" and not (bool((mean >= 0).all()) and float(
                (mean.sum(dim=1) - 1.0).abs().max()) <= 1e-5):
            raise AssertionError(f"task {t}: Dirichlet mean off the simplex")
    params64 = trained.to(dtype=torch.float64)
    cfg64 = dataclasses.replace(serve_cfg, dtype="float64")
    worst = {"plain_f32": 0.0, "f64": 0.0}
    for t, lik in enumerate(serve_cfg.likelihoods):
        got = serve[t](Xs[:ACC_ROWS])
        ref32 = tp.make_serving_predictive(trained, serve_cfg, t,
                                           use_kernel=False)(Xs[:ACC_ROWS])
        ref64 = tp.make_serving_predictive(params64, cfg64, t,
                                           use_kernel=False)(
                                               Xs[:ACC_ROWS].double())
        e32 = [normwise(a, b) for a, b in zip(got, ref32)]
        e64 = [normwise(a, b) for a, b in zip(got, ref64)]
        print(f"  task {t} {type(lik).__name__}: normwise error (mean, var) "
              f"vs plain f32 {e32[0]:.3e}, {e32[1]:.3e}; vs f64 "
              f"{e64[0]:.3e}, {e64[1]:.3e} [card: {smi}]")
        worst["plain_f32"] = max(worst["plain_f32"], *e32)
        worst["f64"] = max(worst["f64"], *e64)
    if not (worst["plain_f32"] <= PLAIN_F32_BOUND
            and worst["f64"] <= F64_BOUND):
        raise AssertionError(f"ten-family served moments: {worst}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        serve_all()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rates = sorted(T * CHUNK / dt for dt in times)
    print(f"ten-family serving throughput: {statistics.median(rates):.1f} "
          f"rows/s, median of 3 passes of {T * CHUNK} rows, min "
          f"{rates[0]:.1f}, max {rates[-1]:.1f} [card: {smi}]")

    # 4. NLPD against float64 on the same draws
    Xn = [X_list[t][:ACC_ROWS] for t in range(T)]
    Yn = [Y_list[t][:ACC_ROWS] for t in range(T)]
    dgen = torch.Generator(device=device).manual_seed(SEED + 13)
    eps = [torch.randn(ACC_ROWS, FAMILY_SAMPLES, lik.dim_f, generator=dgen,
                       device=device) for lik in serve_cfg.likelihoods]
    nlpd = tp.negative_log_predictive(trained, serve_cfg, None, Xn, Yn,
                                      num_samples=FAMILY_SAMPLES, eps=eps)
    nlpd64 = tp.negative_log_predictive(params64, cfg64, None, Xn, Yn,
                                        num_samples=FAMILY_SAMPLES,
                                        eps=[e.double() for e in eps],
                                        use_kernel=False)
    drawn = tp.negative_log_predictive(trained, serve_cfg, dgen, Xn, Yn,
                                       num_samples=FAMILY_SAMPLES)
    r = abs(float(nlpd) - float(nlpd64)) / abs(float(nlpd64))
    print(f"ten-family NLPD ({T} x {ACC_ROWS} rows, {FAMILY_SAMPLES} draws, "
          f"reference scaling): {float(nlpd):.6f}, float64 "
          f"{float(nlpd64):.6f}, relative {r:.3e} (bound {NLPD_BOUND:g}); "
          f"with the generator's own draws {float(drawn):.6f}; phase "
          f"{time.perf_counter() - t_phase:.1f} s [card: {smi}]")
    if not (r <= NLPD_BOUND and bool(torch.isfinite(drawn))):
        raise AssertionError("ten-family NLPD disagrees with float64")

    # 5. the trained model's ELBO on a minibatch without a gradient
    # (predict.elbo_evaluator): the four table families take kernel 6's
    # value-alone launch of the task table, the launch counts from 0 around
    # it
    from hetmogp_tpu_torch.models import elbo as telbo, predict

    batch = ttrain.slice_batch(
        ttrain.extend_for_wraparound(dataset, batches, sizes),
        ttrain.draw_offsets(torch.Generator().manual_seed(SEED + 14), sizes,
                            batches), sizes, batches)
    scales = ttrain.batch_scales(sizes, batches, cfg.torch_dtype, device)
    ck.zero_launch_counts()
    elbo, _ = predict.elbo_evaluator(cfg)(trained, batch, scales)
    torch.cuda.synchronize()
    evaluated = ck.launch_counts()
    with torch.no_grad():
        want, _ = telbo.elbo_fn(trained, batch, scales, cfg, use_kernel=False)
    r = abs(float(elbo) - float(want)) / abs(float(want))
    print(f"ten-family ELBO without a gradient (elbo_evaluator, {T} x "
          f"{TRAIN_B} rows): {float(elbo):.6f}, the plain versions' "
          f"{float(want):.6f}, relative {r:.3e} (bound "
          f"{GRAPH_PLAIN_F32_VE:g}); launches "
          f"{ {k: v for k, v in evaluated.items() if v} } [card: {smi}]")
    if not (r <= GRAPH_PLAIN_F32_VE and evaluated["task_var_exp_value"] == 1
            and evaluated["gh_sweep_value"] == 0
            and evaluated["gh_sweep"] == 0):
        raise AssertionError("the ten-family ELBO without a gradient did "
                             "not take kernel 6's value-alone table")
    del run, state, serve, out, eps
    torch.cuda.empty_cache()
    return counts, evaluated


# ---------------------------------------------------------------------------
# the other optimizers and loops
# ---------------------------------------------------------------------------

# examples/large_scale.py:63-66 with --natgrad: the flagship trainer with
# natural gradients on q(u) (natgrad_lr 0.1) and adam at 0.005 on the rest
NATGRAD_TC = dict(optimizer="natgrad_adam", step_rate=0.005, natgrad_lr=0.1,
                  minibatch="slice", vm_batch_fraction=0.25)
NATGRAD_CALLS = 3
# The natural-gradient trainers against their plain versions, relative
# ELBO.  The "cholesky" retraction's update is P's contractions (g_m =
# P^T g_mean, g_S = P^T diag(c) P) through three triangular products,
# trust-damped: it inherits kernel 3's summation-order difference from
# the plain 3-pass product (~3e-4 of max|P|) as the adam trainer does, so
# the flagship's bounds hold.  The "exact" retraction factorizes A = S^-1
# - 2 lr g_S, whose condition number grows with the data's weight
# (N_t / B_t = 325 times 512 rows of P^T P): its float32 factor carries
# cond(A) * eps of error into S and the KL's log-determinant, so its
# bounds are five times the flagship's.
NATGRAD_BOUNDS = {"cholesky": (GRAPH_PLAIN_F32_VE, GRAPH_PLAIN_F32, GRAPH_F64),
                  "exact": (5 * GRAPH_PLAIN_F32_VE, 5 * GRAPH_PLAIN_F32,
                            5 * GRAPH_F64)}
# the rest of the optimizers, one trainer each: the steps of its call
OTHER_STEPS = 300
OTHER_TCS = {
    # climin Adadelta with its lookahead (momentum 0.9), at the step rate
    # of examples/optimizers.py
    "adadelta": dict(optimizer="adadelta", step_rate=0.05, momentum=0.9,
                     minibatch="slice", vm_batch_fraction=0.25),
    # examples/production_training.py:64-68 at the flagship's rate
    "adam, warmup_cosine, clip 100": dict(
        optimizer="adam", step_rate=0.005, minibatch="slice",
        vm_batch_fraction=0.25, lr_schedule="warmup_cosine",
        lr_schedule_kwargs=(("warmup_steps", 20), ("decay_steps", 1000)),
        clip_grad_norm=100.0),
    "adam, gather": dict(optimizer="adam", step_rate=0.005,
                         minibatch="gather", vm_batch_fraction=0.25),
    "natgrad, vem=False": dict(NATGRAD_TC),
}
VEM_ROWS = 8192  # rows a task of the batch VEM run
VEM_TC = dict(vem_iters=2, batch_inner_iters=25)
SVI_FIT_STEPS = 50


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def per_cycle(run, cycle: int) -> dict:
    """The hand kernels' launches per ``cycle`` steps of the trainer
    ``run``'s graphs (the VE/VM schedule's cycle, or as many joint
    steps)."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    reps = ({"ve": cycle - 1, "vm": 1} if run.vem else {"joint": cycle})
    return {k: sum(run.capture_launches[kind][k] * reps[kind]
                   for kind in run.capture_launches)
            for k in ck.launch_counts()}


def graphed_against_eager(cfg, tc, params, dataset, sizes, batches, vem,
                          seed, what, smi, plain_bounds=None):
    """A fresh make_scan_trainer's first call, ten steps on a drawn
    stream, against ten eager steps of the same body on the same rows:
    bitwise (the ELBO, every parameter and the optimizer's state and
    S^-1); with ``plain_bounds`` (f32 up to the first VM step, f32, f64)
    also against the plain versions.  Returns (run, state, elbos)."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

    device = params.Z.device
    run = tp.make_scan_trainer(cfg, tc, sizes, batches,
                               steps_per_call=GRAPH_CALL_STEPS, vem=vem)
    stream = run.sampler.draw(torch.Generator().manual_seed(seed), 10)
    t0 = time.perf_counter()
    state, graphed = run(tp.init_train_state(params, cfg, tc, cache_luu=vem),
                         dataset, **{run.sampler.name: stream})
    _sync(device)
    first = time.perf_counter() - t0
    prepared = run.sampler.prepare(dataset)
    runs = [("eager", cfg, prepared, params, True)]
    if plain_bounds is not None:
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        runs += [("plain_f32", cfg, prepared, params, False),
                 ("plain_f64", cfg64,
                  tuple(tp.TaskData(*(a.double() for a in td))
                        for td in prepared),
                  params.to(dtype=torch.float64), False)]
    elbos = {"graphed": graphed.double().cpu()}
    for name, c, data, p, use_kernel in runs:
        step = ttrain.make_step(c, tc, vem=vem, use_kernel=use_kernel)
        s = tp.init_train_state(p, c, tc, cache_luu=vem)
        scales = ttrain.batch_scales(sizes, batches, c.torch_dtype, device,
                                     tc.minibatch)
        out = []
        for row in stream:
            s, metrics = step(s, run.sampler.on_host(data, row), scales)
            out.append(metrics["elbo"])
        elbos[name] = torch.stack(out).double().cpu()
        if name == "eager":
            eager = s
    same = all(torch.equal(a, b) for a, b in zip(
        ttrain._state_tensors(state), ttrain._state_tensors(eager)))
    bitwise = torch.equal(elbos["graphed"], elbos["eager"])
    for name in elbos:
        print(f"  {name:9s} ELBO {elbos[name].numpy().round(3).tolist()}"
              f" [card: {smi}]")
    msg = (f"{what}: first call of 10 steps {first:.3f} s, of which warm-up "
           f"and capture {run.capture_seconds or 0.0:.3f} s; launches per "
           f"graph {run.capture_launches}; ten graphed steps bitwise equal "
           f"to ten eager steps: ELBO {bitwise}, every parameter, the "
           f"optimizer's state and the caches {same}")
    ok = bitwise and same and bool(torch.isfinite(elbos["graphed"]).all())
    if plain_bounds is not None:
        def rel(b, upto=None):
            r = (elbos["graphed"] - elbos[b]).abs() / elbos[b].abs()
            return float(r[:upto].max())

        first_vm = tc.ve_steps_per_vm + 1 if vem else None
        got = (rel("plain_f32", first_vm), rel("plain_f32"),
               rel("plain_f64"))
        msg += (f"; vs plain f32 {got[0]:.3e} up to the first VM step "
                f"(bound {plain_bounds[0]:g}), {got[1]:.3e} over all ten "
                f"(bound {plain_bounds[1]:g}); vs plain f64 {got[2]:.3e} "
                f"(bound {plain_bounds[2]:g})")
        ok = ok and all(g <= b for g, b in zip(got, plain_bounds))
    print(f"{msg} [card: {smi}]")
    if not ok:
        raise AssertionError(f"{what}: graphed steps disagree with eager "
                             "or plain")
    return run, state, graphed


def backoff_counts(run) -> tuple:
    """(steps at lr/4, steps skipped) among the last call's VE (or joint)
    steps: ng_backoff 1 and 2."""
    ve = torch.tensor([k != "vm" for k in run.step_kinds])
    codes = run.ng_backoff.cpu()[ve]
    return int((codes == 1).sum()), int((codes == 2).sum())


def attempt_ms(S_inv, Lq, m, config, lr: float) -> dict:
    """Device time of the retractions' attempts at the step's shapes, by
    CUDA events: what computing the lr/4 attempt beside the first costs a
    VE step (the backoff is selected on the device, so both attempts
    always run).  "exact" is train._exact_attempts at the rate lr alone,
    its (Q, M, M) A, and at both rates, the (2 Q, M, M) stack the step
    factors in one call; "cholesky" one attempt, the step runs two.  The
    operations are natgrad_ve_step's, on a trained S^-1 and q (g_S = 0:
    A = S^-1)."""
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.ops import linalg

    eye = torch.eye(Lq.shape[-1], dtype=Lq.dtype, device=Lq.device)
    theta1 = (S_inv @ m[..., None])[..., 0]
    g_S, d_eta1 = torch.zeros_like(S_inv), torch.zeros_like(theta1)
    H = 0.5 * (S_inv + S_inv.mT)

    def exact(lrs):
        return lambda: ttrain._exact_attempts(S_inv, g_S, theta1, d_eta1,
                                              lrs, config, eye)

    def cholesky():
        X = 2.0 * lr * linalg._phi(H)
        mx = torch.amax(torch.abs(X), dim=(-2, -1), keepdim=True)
        X = X * torch.clamp(0.3 / torch.clamp(mx, min=1e-30), max=1.0)
        return Lq + linalg.matmul_tril(Lq, X)

    def graphed(fn):  # the trainer replays its steps as CUDA graphs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph.replay

    times = {}
    for name, fn in (("exact", exact((lr,))),
                     ("exact_pair", exact((lr, lr * 0.25))),
                     ("cholesky", cholesky)):
        times[name] = statistics.median(device_times_ms(fn))
        times[name + ", graphed"] = statistics.median(
            device_times_ms(graphed(fn)))
    return times


def optimizers_phase(smi: str, device="cuda") -> dict:
    """The other optimizers and loops at the flagship's width:

    1. examples/large_scale.py --natgrad: the flagship trainer with
       natural gradients, "cholesky" (the default) and "exact" at
       natgrad_lr 0.1, each through a fresh make_scan_trainer: ten graphed
       steps against eager (bitwise) and the plain versions in float32 and
       float64, NATGRAD_CALLS timed calls of GRAPH_CALL_STEPS steps, the
       backoff codes, a rising ELBO, a profile of PROFILE_STEPS steps with
       the hand kernels' calls held to the replays; the launch counts go
       to 0 before the "cholesky" trainer's first call and are read after
       its timed calls; then the cost of the backoff's second attempt;
    2. Adadelta with its lookahead, adam with warmup_cosine and clipping,
       adam on the gather sampler, and natural gradients in joint mode
       (vem=False), one trainer each: ten graphed steps bitwise against
       eager, then a call of OTHER_STEPS steps with a rising ELBO;
    3. batch VEM (vem_algorithm, masked L-BFGS) on VEM_ROWS rows a task:
       the ELBO before and after each half-step, rising; and svi_fit over
       a MinibatchStream for SVI_FIT_STEPS steps of the un-whitened model
       on the solve path (fast_projection=False).

    Returns the natural-gradient trainer's launch counts."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.models import elbo as telbo
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    cfg, _, params, dataset = training_model(device, precision="high")
    T = cfg.num_tasks
    sizes, batches = (TRAIN_N_PER,) * T, (TRAIN_B,) * T
    cycle = 5  # ve_steps_per_vm + 1
    profiled = torch.device(device).type == "cuda"

    # 1. large_scale --natgrad, both retractions
    counts, trained = None, {}
    for retraction in ("cholesky", "exact"):
        tc = tp.TrainConfig(**NATGRAD_TC, natgrad_retraction=retraction)
        what = (f"natgrad trainer (make_scan_trainer, \"high\", "
                f"{retraction}, natgrad_lr {tc.natgrad_lr})")
        if counts is None:
            ck.zero_launch_counts()
        run, state, first = graphed_against_eager(
            cfg, tc, params, dataset, sizes, batches, True, SEED + 20, what,
            smi, plain_bounds=NATGRAD_BOUNDS[retraction])
        gen = torch.Generator().manual_seed(SEED + 21)
        calls, rates, backoffs = [first], [], [backoff_counts(run)]
        for _ in range(NATGRAD_CALLS):
            t0 = time.perf_counter()
            state, e = run(state, dataset, gen)
            _sync(device)
            rates.append(GRAPH_CALL_STEPS / (time.perf_counter() - t0))
            calls.append(e)
            backoffs.append(backoff_counts(run))
        if counts is None:
            counts = ck.launch_counts()
        report_rates(what, rates, GRAPH_CALL_STEPS, smi)
        e = torch.cat(calls).double().cpu()
        start, end = float(e[:10].mean()), float(e[-10:].mean())
        n1, n2 = (sum(b[i] for b in backoffs) for i in (0, 1))
        print(f"{what}: ELBO over {e.numel()} steps, mean of the first ten "
              f"{start:.3f}, of the last ten {end:.3f}; ng_backoff 1 (lr/4) "
              f"in {n1} VE steps, 2 (skipped) in {n2}; launches per "
              f"{cycle}-step cycle {per_cycle(run, cycle)} [card: {smi}]")
        if not (torch.isfinite(e).all() and end > start):
            raise AssertionError(f"{what}: ELBO not finite or not rising")
        if profiled:
            offsets = ttrain.draw_offset_stream(gen, sizes, batches,
                                                PROFILE_STEPS)
            held = {}
            profile_replays(run, lambda: held.update(
                out=run(state, dataset, offsets=offsets)),
                f"{what}, one call of {PROFILE_STEPS} steps", smi)
            state = held["out"][0]
        trained[retraction] = (state.params, state.S_inv)
        del run
    print(f"natgrad trainer launches counted from 0 around the \"cholesky\" "
          f"trainer's calls: {counts} [card: {smi}]")
    want = ("rbf_K_batched_vec", "rbf_backward", "tril_projection_3pass_tma",
            "tril_projection_tma", "tril_right_tma", "tril_right3_tma")
    if profiled and any(counts[k] < 1 for k in want):
        raise AssertionError(f"the natgrad trainer did not run the kernels: "
                             f"{counts}")
    if profiled:
        p, S_inv = trained["exact"]
        cost = attempt_ms(S_inv, torch.tril(p.q_sqrt), p.q_mu, cfg,
                          NATGRAD_TC["natgrad_lr"])
        for how in ("", ", graphed"):
            one, pair = cost["exact" + how], cost["exact_pair" + how]
            print(f"natgrad backoff, both attempts computed and selected on "
                  f"the device{how or ', eager'}: exact, one attempt "
                  f"{one:.4f} ms and both attempts factored in one call "
                  f"{pair:.4f} ms, so the second costs {pair - one:.4f} ms; "
                  f"cholesky, one attempt {cost['cholesky' + how]:.4f} ms; "
                  f"device time at (Q, M, M) = ({Q}, {M}, {M}), median of "
                  f"20 [card: {smi}]")
    del trained

    # 2. the rest of the optimizers
    for i, (name, kw) in enumerate(OTHER_TCS.items()):
        tc = tp.TrainConfig(**kw)
        vem = name != "natgrad, vem=False"
        what = f"{name} trainer (make_scan_trainer, \"high\")"
        run, state, first = graphed_against_eager(
            cfg, tc, params, dataset, sizes, batches, vem, SEED + 30 + i,
            what, smi)
        rows = run.sampler.draw(torch.Generator().manual_seed(SEED + 40 + i),
                                OTHER_STEPS)
        t0 = time.perf_counter()
        state, e = run(state, dataset, **{run.sampler.name: rows})
        _sync(device)
        rate = OTHER_STEPS / (time.perf_counter() - t0)
        e = torch.cat([first, e]).double().cpu()
        start, end = float(e[:10].mean()), float(e[-10:].mean())
        extra = ""
        if run.ng_backoff is not None:
            extra = ("; ng_backoff (1, 2) in the call's steps "
                     f"{backoff_counts(run)}")
        print(f"{what}: one call of {OTHER_STEPS} steps "
              f"({tc.minibatch}), "
              f"{rate:.2f} steps/s; ELBO mean of the first ten {start:.3f}, "
              f"of the last ten {end:.3f}; launches per {cycle}-step cycle "
              f"{per_cycle(run, cycle)}{extra} [card: {smi}]")
        if not (torch.isfinite(e).all() and end > start):
            raise AssertionError(f"{what}: ELBO not finite or not rising")
        del run, state

    # 3. batch VEM, and svi_fit on the un-whitened model
    X_list = [td.X.cpu().numpy() for td in dataset]
    Y_list = [td.Y.cpu().numpy() for td in dataset]
    Xv, Yv = [x[:VEM_ROWS] for x in X_list], [y[:VEM_ROWS] for y in Y_list]
    data, _ = tp.full_batch(Xv, Yv, dtype=cfg.torch_dtype, device=device)
    ones = torch.ones(T, dtype=cfg.torch_dtype, device=device)

    def elbo(p, c):  # the ELBO of the VEM_ROWS rows a task
        with torch.no_grad():
            return float(telbo.elbo_fn(p, data, ones, c)[0])

    vtc = tp.TrainConfig(**VEM_TC)
    e0 = elbo(params, cfg)
    t0 = time.perf_counter()
    _, hist = tp.vem_algorithm(params, cfg, Xv, Yv, vtc)
    _sync(device)
    half = (time.perf_counter() - t0) / len(hist)
    path = [e0, *hist.tolist()]
    print(f"batch VEM (vem_algorithm, {VEM_TC['vem_iters']} x VE and VM "
          f"L-BFGS of {VEM_TC['batch_inner_iters']} iterations, {T} x "
          f"{VEM_ROWS} rows, M {M}, Q {Q}): ELBO at the start and after each "
          f"half-step {[round(v, 3) for v in path]}; {half:.3f} s a "
          f"half-step (mean) [card: {smi}]")
    if not (np.isfinite(path).all() and all(b > a for a, b in
                                            zip(path, path[1:]))):
        raise AssertionError("batch VEM: ELBO not finite or not rising")

    ucfg = dataclasses.replace(cfg, whiten=False)
    utc = tp.TrainConfig(optimizer="adam", step_rate=0.005, minibatch="slice",
                         vm_batch_fraction=0.25, fast_projection=False)
    stream = tp.MinibatchStream(X_list, Y_list, TRAIN_B, seed=SEED + 50,
                                dtype=cfg.torch_dtype, device=device)
    # the flagship's q in u-space: u = Luu v (S = Kuu for q_sqrt = I)
    uparams = telbo.unwhiten_params(params, ucfg)
    t0 = time.perf_counter()
    fitted, hist = tp.svi_fit(uparams, ucfg, utc, stream, SVI_FIT_STEPS)
    dt = time.perf_counter() - t0
    before, after = elbo(uparams, ucfg), elbo(fitted, ucfg)
    print(f"svi_fit, un-whitened, fast_projection=False, {SVI_FIT_STEPS} "
          f"steps over a MinibatchStream: {SVI_FIT_STEPS / dt:.2f} steps/s; "
          f"ELBO of the first {VEM_ROWS} rows a task before {before:.3f}, "
          f"after {after:.3f}; minibatch ELBOs {hist[0]:.3f} ... "
          f"{hist[-1]:.3f}; phase {time.perf_counter() - t_phase:.1f} s "
          f"[card: {smi}]")
    if not (np.isfinite(hist).all() and after > before):
        raise AssertionError("svi_fit: ELBO not finite or not rising")
    del dataset, stream, uparams, fitted, data
    if profiled:
        torch.cuda.empty_cache()
    return counts


# The lifecycle of the flagship (examples/production_training.py's path):
# checkpointed training with a crash and an exact resume, the whole model
# saved and loaded, and the serving and predictive paths exported with
# torch.export and run from the exported programs.
LIFE_STEPS, LIFE_CHUNK, LIFE_KEEP = 200, 50, 2
LIFE_STOP = 100  # where the second run is cut
LIFE_PRED_ROWS = 4096  # rows a task of the exported predictive
# The exported predictive replays the eager path's operators and kernels
# on the same inputs: anything but a reordering of a sum is a fault.
EXPORT_PRED_BOUND = 1e-6
SERVE_TURNS = 5  # eager and exported serving calls, each, in turns
F64_ISLAND_STEPS, F64_ISLAND_TURNS = 50, 3
RANK_STEPS, RANK_CALLS = 200, 3


def _leaves_equal(a, b) -> bool:
    from hetmogp_tpu_torch.models.params import leaves

    return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a),
                                                           leaves(b)))


def _dirs(d) -> list:
    from hetmogp_tpu_torch import train as ttrain

    return [p.name for _, p in ttrain._step_checkpoints(d)]


def _serving_rates(fns: dict, X, rows: int, turns: int) -> dict:
    """rows/s of each function of ``fns`` (name -> callable of X), called
    in turns ``turns`` times each, under inference mode."""
    rates = {k: [] for k in fns}
    with torch.inference_mode():
        for i in range(turns):
            order = list(fns) if i % 2 == 0 else list(fns)[::-1]
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[k](X)
                torch.cuda.synchronize()
                rates[k].append(rows / (time.perf_counter() - t0))
    return rates


def _median_line(name: str, rates, unit: str) -> str:
    r = sorted(rates)
    med = statistics.median(r)
    return (f"{name} {med:.1f} {unit} (median of {len(r)}, min {r[0]:.1f}, "
            f"max {r[-1]:.1f}, spread {(r[-1] - r[0]) / med * 100:.2f}%)")


def lifecycle_phase(smi: str) -> dict:
    """The user's lifecycle at the flagship's width; returns the hand
    kernels' launches over the phase, counted from 0 at its start.  The
    checkpoints (~250 MB) go to a temporary directory, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hetmogp_lifecycle_") as root:
        return _lifecycle(smi, root)


def _lifecycle(smi: str, root: str) -> dict:
    from pathlib import Path

    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import checkpoint, export
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    root = Path(root)
    t_phase = time.perf_counter()
    ck.zero_launch_counts()

    # 1. checkpoints, a crash at LIFE_STOP and a resume to LIFE_STEPS
    cfg, tc, X_list, Y_list, rng = training_arrays()
    cfg = dataclasses.replace(cfg, ve_fwd_precision="high")
    Z = rng.rand(M, DX).astype(np.float32)
    params = tp.init_params(rng, cfg, Z, lengthscale=0.2, variance=0.5,
                            q_mu_scale=0.1, device="cuda")
    fit = dict(batch_size=TRAIN_B, train_config=tc,
               steps_per_call=LIFE_CHUNK, checkpoint_every=LIFE_CHUNK,
               keep_last=LIFE_KEEP)

    def model():
        return tp.SVMOGP(cfg, X_list, Y_list, None, params=params)

    def gen():
        return torch.Generator().manual_seed(SEED + 7)

    t0 = time.perf_counter()
    whole = model().fit_svi_on_device(num_steps=LIFE_STEPS, generator=gen(),
                                      checkpoint_dir=root / "whole", **fit)
    t_whole = time.perf_counter() - t0
    cut = model().fit_svi_on_device(num_steps=LIFE_STOP, generator=gen(),
                                    checkpoint_dir=root / "resumed", **fit)
    resumed = model().fit_svi_on_device(num_steps=LIFE_STEPS,
                                        generator=torch.Generator(),
                                        checkpoint_dir=root / "resumed",
                                        resume=True, **fit)
    hist = np.concatenate([cut.elbo_history, resumed.elbo_history])
    same_params = _leaves_equal(whole.params, resumed.params)
    same_hist = np.array_equal(hist, whole.elbo_history)
    kept = {k: _dirs(root / k) for k in ("whole", "resumed")}
    want = [f"step_{LIFE_STEPS - LIFE_CHUNK}", f"step_{LIFE_STEPS}"]
    print(f"lifecycle: {LIFE_STEPS} graphed steps with checkpoints every "
          f"{LIFE_CHUNK} (keep_last={LIFE_KEEP}) in {t_whole:.3f} s; a run "
          f"cut at {LIFE_STOP} and resumed to {LIFE_STEPS}: params bitwise "
          f"equal to the uninterrupted run {same_params}, ELBO history "
          f"({hist.size} steps) bitwise equal {same_hist}; kept "
          f"directories {kept}; final ELBO {whole.elbo_history[-1]:.3f} "
          f"[card: {smi}]")
    if not (same_params and same_hist and all(v == want
                                              for v in kept.values())
            and np.isfinite(hist).all()):
        raise AssertionError("the resumed run is not the uninterrupted one")
    path = root / "whole" / want[-1] / ttrain.STEP_CHECKPOINT
    template = (params, ttrain.init_optimizer_state(params, tc))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_loaded, opt, step, _ = checkpoint.load_checkpoint(path, *template)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(root / "again.npz", p_loaded, opt_state=opt,
                               step=step, generator=gen())
    t_save = time.perf_counter() - t0
    print(f"checkpoint: {path.stat().st_size / 1e6:.3f} MB (params, adam's "
          f"moments, the generator), save {t_save:.3f} s, load "
          f"{t_load:.3f} s [card: {smi}]")

    # 2. the whole model saved and loaded
    whole.save(root / "model.npz")
    back = tp.SVMOGP.load(root / "model.npz", X_list, Y_list,
                           device="cuda")
    e_saved, e_loaded = whole.log_likelihood(), back.log_likelihood()
    print(f"SVMOGP.save/load: full-data ELBO before {e_saved!r}, after "
          f"{e_loaded!r}, equal {e_saved == e_loaded} [card: {smi}]")
    if not (e_saved == e_loaded and np.isfinite(e_saved)
            and _leaves_equal(whole.params, back.params)):
        raise AssertionError("the loaded model is not the saved one")

    # 3. the exported serving path against the eager one, one task
    trained = whole.params
    task = 2  # Categorical(K=3): the 2-D quadrature grid
    Xs = torch.tensor(np.random.default_rng(SEED).random((CHUNK, DX)),
                      dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    blob = export.export_serving_predictive(trained, cfg, Xs, task)
    t_export = time.perf_counter() - t0
    ops = export.exported_ops(blob)
    own = {k: v for k, v in ops.items() if k.startswith("hetmogp::")}
    served = export.load_predictive(blob)
    state = export.serving_state(trained, cfg)
    args = (*export.params_args(trained), *state)
    eager = tp.make_serving_predictive(trained, cfg, task)
    with torch.inference_mode():
        before = ck.launch_counts()
        want_out = eager(Xs)
        torch.cuda.synchronize()
        mid = ck.launch_counts()
        got = served(*args, Xs)
        torch.cuda.synchronize()
        after = ck.launch_counts()
    n_eager = {k: mid[k] - before[k] for k in mid}
    n_export = {k: after[k] - mid[k] for k in mid}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want_out))
    print(f"exported serving ({CHUNK} rows, task {task}): export "
          f"{t_export:.3f} s, {len(blob) / 1e6:.3f} MB, hetmogp:: nodes "
          f"{own}; moments bitwise equal to make_serving_predictive "
          f"{bitwise}; launches of one call, exported {n_export}, eager "
          f"{n_eager} [card: {smi}]")
    if not (bitwise and own.get("hetmogp::rbf_K_batched", 0) >= 1
            and own.get("hetmogp::tril_projection_3pass", 0)
            + own.get("hetmogp::tril_projection", 0) >= 1
            and own.get("hetmogp::quad_diag", 0) >= 1
            and n_export == n_eager and n_export["tril_right_tma"] >= 1):
        raise AssertionError("the exported serving path is not the eager one")
    rates = _serving_rates({"eager": eager,
                            "exported": lambda X: served(*args, X)},
                           Xs, CHUNK, SERVE_TURNS)
    print("serving rows/s in turns: "
          + "; ".join(_median_line(k, v, "rows/s") for k, v in rates.items())
          + f" [card: {smi}]")

    # 4. the exported predictive of all six tasks on the solve path
    Xp = [torch.tensor(np.random.default_rng(SEED + t).random(
        (LIFE_PRED_ROWS, DX)), dtype=torch.float32, device="cuda")
        for t in range(cfg.num_tasks)]
    blob = export.export_predictive(trained, cfg, Xp)
    pred = export.load_predictive(blob)
    with torch.inference_mode():
        got = pred(*export.params_args(trained), *Xp)
    m_ref, v_ref = tp.predictive(trained, cfg, Xp)
    ref = [a for mv in zip(m_ref, v_ref) for a in mv]
    err = max(normwise(a, b) for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    own = {k: v for k, v in export.exported_ops(blob).items()
           if k.startswith("hetmogp::")}
    print(f"exported predictive (6 x {LIFE_PRED_ROWS} rows): hetmogp:: "
          f"nodes {own}; normwise error against the eager predictive "
          f"{err:.3e} (bound {EXPORT_PRED_BOUND:g}), bitwise {same} "
          f"[card: {smi}]")
    if not (err <= EXPORT_PRED_BOUND and own):
        raise AssertionError("the exported predictive disagrees")

    # 5. rank 2: eight latent copies through the graphed trainer
    rank_phase(smi)

    # 6. the float64 factorization island against "same", in turns
    island_phase(smi)

    counts = ck.launch_counts()
    print(f"lifecycle phase: {time.perf_counter() - t_phase:.3f} s; "
          f"launches counted from 0 at its start {counts} [card: {smi}]")
    for k in ("rbf_K_batched_vec", "tril_projection_tma",
              "tril_projection_3pass_tma", "rbf_backward", "tril_right_tma",
              "tril_right3_tma"):
        if counts[k] < 1:
            raise AssertionError(f"the lifecycle path did not run {k}")
    return counts


@contextlib.contextmanager
def launch_shapes():
    """Yield {launcher: {(Q, N, M), ...}}, the shapes of the kernel launches
    made inside the block: the launchers look their launch helpers up in
    the module at each call, and wrappers there record them."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    seen, originals = {}, {}
    for helper, shape in (("_rbf_launch", lambda w, e, X, Z, *a, **k:
                           (Z.shape[0], X.shape[0], Z.shape[1])),
                          ("_launch", lambda w, e, A, *a, **k:
                           tuple(A.shape)),
                          ("_right_launch", lambda w, e, A, *a, **k:
                           tuple(A.shape)),
                          ("_out_launch", lambda w, e, A, *a, **k:
                           tuple(A.shape)),
                          ("_panel_launch", lambda w, e, A, *a, **k:
                           tuple(A.shape))):
        originals[helper] = getattr(ck, helper)

        def record(wrapper, *a, _f=originals[helper], _s=shape, **k):
            seen.setdefault(wrapper.__name__, set()).add(_s(wrapper, *a, **k))
            return _f(wrapper, *a, **k)
        setattr(ck, helper, record)
    try:
        yield seen
    finally:
        for name, f in originals.items():
            setattr(ck, name, f)


def rank_phase(smi: str) -> None:
    """The flagship at coregionalization rank 2 (Q=4 groups, 8 latent
    copies): ten graphed steps bitwise against eager and within the
    flagship's bounds of the plain versions in float32 and float64, with
    the RBF kernel and kernel 3 launched at batch 8."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    cfg, tc, params, dataset = training_model(precision="high", rank=2)
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    with launch_shapes() as shapes:
        run, state, _ = graphed_against_eager(
            cfg, tc, params, dataset, sizes, batches, True, SEED + 8,
            "rank 2 (8 latent copies), \"high\"", smi,
            plain_bounds=(GRAPH_PLAIN_F32_VE, GRAPH_PLAIN_F32, GRAPH_F64))
    # the model's own launches, at depth M; the refresh's levels apart
    seen = {k: {q for q, _, m in v if m == M} for k, v in shapes.items()}
    levels = {k: {s for s in v if s[-1] != M} for k, v in shapes.items()}
    print(f"rank 2: batches the kernels were launched at {seen}; the "
          f"refresh's launches (Q, N, M) {levels} [card: {smi}]")
    gen = torch.Generator().manual_seed(SEED + 10)
    rates = []
    for _ in range(RANK_CALLS):
        stream = run.sampler.draw(gen, RANK_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run(state, dataset, offsets=stream)
        torch.cuda.synchronize()
        rates.append(RANK_STEPS / (time.perf_counter() - t0))
    report_rates("rank 2 graphed trainer (\"high\")", rates, RANK_STEPS,
                 smi)
    if not ({"rbf_K_batched_vec", "tril_projection_3pass_tma",
             "tril_right_tma", "tril_right3_tma", "tril_out3_tma"}
            <= set(seen)
            and all(b == {Q * 2} for b in seen.values() if b)
            and {k: v for k, v in levels.items() if v}
            == refresh_shapes(Q * 2)):
        raise AssertionError(f"rank 2 did not run the kernels at batch 8: "
                             f"{seen}")


def island_phase(smi: str) -> None:
    """The flagship with chol_dtype="float64" against "same": the graphed
    trainer's steps/s over F64_ISLAND_STEPS-step calls in turns, from one
    state and one offset stream, and the ELBO difference."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

    cfg, tc, params, dataset = training_model(precision="high")
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    stream = ttrain.draw_offset_stream(torch.Generator().manual_seed(
        SEED + 9), sizes, batches, F64_ISLAND_STEPS)
    runs, elbos, rates = {}, {}, {}
    for chol in ("same", "float64"):
        c = dataclasses.replace(cfg, chol_dtype=chol)
        runs[chol] = (tp.make_scan_trainer(c, tc, sizes, batches,
                                           steps_per_call=GRAPH_CALL_STEPS),
                      tp.init_train_state(params, c))
        _, e = runs[chol][0](runs[chol][1], dataset, offsets=stream)
        elbos[chol] = e.double().cpu()
        rates[chol] = []
    for i in range(F64_ISLAND_TURNS):
        for chol in (("same", "float64") if i % 2 == 0
                     else ("float64", "same")):
            run, state = runs[chol]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(state, dataset, offsets=stream)
            torch.cuda.synchronize()
            rates[chol].append(F64_ISLAND_STEPS / (time.perf_counter() - t0))
    rel = float(((elbos["float64"] - elbos["same"]).abs()
                 / elbos["same"].abs()).max())
    print("chol_dtype at \"high\", graphed steps/s over calls of "
          f"{F64_ISLAND_STEPS} steps in turns: "
          + "; ".join(_median_line(k, v, "steps/s") for k, v in rates.items())
          + f"; largest relative ELBO difference over the first "
          f"{F64_ISLAND_STEPS} steps {rel:.3e} [card: {smi}]")
    if not (torch.isfinite(elbos["float64"]).all() and rel < GRAPH_F64):
        raise AssertionError("the float64 island's trajectory is off")

# ---------------------------------------------------------------------------
# parallelism: a (2, 2) mesh of gloo ranks sharing the card, and a world-1
# NCCL mesh whose collectives the graphs capture
# ---------------------------------------------------------------------------

PAR_WORLD, PAR_LATENT = 4, 2  # a ("data", "latent") mesh of 2 x 2
PAR_STEPS = 10  # sharded steps held against unsharded eager ones
PAR_CUT, PAR_FIT = 50, 100  # the sharded checkpoint, and the run's length
PAR_TIMED = 100  # steps of the timed call of the four ranks
PAR_SERVE_ROWS = 65536  # rows a task of the sharded predictive
# predictive_sharded against make_serving_predictive, normwise: the same
# kernels on the same rows and latents (2 of the 4 a rank), whose mixing
# sums the two ranks' partial sums instead of four terms at once
PAR_SERVE_BOUND = 1e-5
PAR_TIMEOUT = 120  # seconds a collective may wait before its rank fails
NCCL_TURNS = 3  # timed calls of GRAPH_CALL_STEPS steps a trainer, in turns


def _flagship_arrays(precision="high"):
    """training_model's config, params, X_list and Y_list, without the
    dataset on the card."""
    import hetmogp_tpu_torch as tp

    cfg, tc, X_list, Y_list, rng = training_arrays()
    cfg = dataclasses.replace(cfg, ve_fwd_precision=precision)
    Z = rng.rand(M, DX).astype(np.float32)
    params = tp.init_params(rng, cfg, Z, lengthscale=0.2, variance=0.5,
                            q_mu_scale=0.1, device="cuda")
    return cfg, tc, params, X_list, Y_list


def _serving_inputs():
    rng = np.random.RandomState(SEED + 12)
    return [rng.rand(PAR_SERVE_ROWS, DX).astype(np.float32) for _ in range(6)]


def _parallel_rank(rank, world, root, offsets, timed):
    """One rank of the (2, 2) mesh on the card (gloo): ten sharded steps
    with the kernels' launches and shapes, a timed call, the sharded
    checkpoint cut and resumed, and the sharded predictive."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.models import predict
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.parallel import collectives, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    ck.load()  # the parent built the library: no rank runs nvcc
    cfg, tc, params, X_list, Y_list = _flagship_arrays()
    mesh = sharding.model_mesh("cuda", latent=PAR_LATENT)
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    dataset = tp.prepare_dataset_on_device(cfg, X_list, Y_list, mesh=mesh)
    run = tp.make_scan_trainer(cfg, tc, sizes, batches,
                               steps_per_call=PAR_STEPS, mesh=mesh)
    state = tp.init_train_state(sharding.shard_params(mesh, params), cfg, tc,
                                mesh=mesh)
    out = {"shard_rows": [td.X.shape[0] for td in dataset]}
    torch.cuda.synchronize()
    ck.zero_launch_counts()
    collectives.zero_collective_counts()
    with launch_shapes() as shapes:
        state, elbos = run(state, dataset, offsets=offsets)
    torch.cuda.synchronize()
    out.update(elbos=elbos.double().cpu().numpy(), captured=run.captured,
               counts=ck.launch_counts(), shapes=shapes,
               collectives=collectives.collective_counts(),
               q_sqrt=tuple(state.params.q_sqrt.shape))
    # steps/s: four ranks sharing the card, collectives through the host
    t0 = time.perf_counter()
    state, e = run(state, dataset, offsets=timed)
    torch.cuda.synchronize()
    out["rate"] = timed.shape[0] / (time.perf_counter() - t0)
    out["timed_finite"] = bool(torch.isfinite(e).all())
    # the all-reduce of a VE step's gradient (this rank's q_mu and
    # q_sqrt) over the data axis, through the host
    comm = sharding.mesh_comm(mesh, cfg)
    grad = torch.ones(state.params.q_mu.numel()
                      + state.params.q_sqrt.numel(), device="cuda")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comm.data_sum_([grad])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["grad_allreduce"] = (grad.numel() * 4, statistics.median(times) * 1e3)
    # the sharded checkpoint: a run cut at PAR_CUT and resumed, against
    # the uninterrupted one
    kw = dict(steps_per_call=PAR_CUT, mesh=mesh, dataset=dataset,
              checkpoint_every=PAR_CUT)

    def fit(n, d, resume=False):
        return tp.svi_fit_on_device(
            params, cfg, tc, X_list, Y_list, TRAIN_B, n,
            generator=torch.Generator().manual_seed(SEED + 11),
            checkpoint_dir=os.path.join(root, d), resume=resume, **kw)

    t0 = time.perf_counter()
    pa, ha = fit(PAR_FIT, "a")
    out["fit_seconds"] = time.perf_counter() - t0
    _, hb1 = fit(PAR_CUT, "b")
    pb, hb2 = fit(PAR_FIT, "b", resume=True)
    out["resume_bitwise"] = bool(
        np.array_equal(ha, np.concatenate([hb1, hb2]))
        and all(torch.equal(getattr(pa, f), getattr(pb, f))
                for f in ("Z", "q_mu", "q_sqrt", "log_lengthscale",
                          "log_variance", "W")))
    step_dir = os.path.join(root, "a", f"step_{PAR_FIT}")
    out["ckpt_files"] = sorted(os.listdir(step_dir))
    out["ckpt_bytes"] = sum(os.path.getsize(os.path.join(step_dir, f))
                            for f in out["ckpt_files"])
    out["fit_elbo"] = (float(ha[:10].mean()), float(ha[-10:].mean()))
    # the sharded predictive against the one-process serving path
    X = _serving_inputs()
    ck.zero_launch_counts()
    collectives.zero_collective_counts()
    with collectives.record_collectives() as log, launch_shapes() as seen:
        m, v = predict.predictive_sharded(params, cfg, X, mesh)
    torch.cuda.synchronize()
    out["serve_counts"] = ck.launch_counts()
    out["serve_shapes"] = seen
    out["serve_collectives"] = sorted({c[:2] for c in log})
    errs = []
    for t in range(cfg.num_tasks):
        ref_m, ref_v = predict.make_serving_predictive(params, cfg, t)(X[t])
        errs.append(max(normwise(m[t], ref_m), normwise(v[t], ref_v)))
    out["serve_err"] = max(errs)
    out["serve_finite"] = all(bool(torch.isfinite(a).all()) for a in m + v)
    return out


def parallel_phase(smi: str) -> None:
    """The sharded trainer, checkpoints and predictive on the card: four
    gloo ranks of a (2, 2) mesh sharing it, then a world-1 NCCL mesh in
    this process whose collectives the graphs capture."""
    parallel_gloo_phase(smi)
    parallel_nccl_phase(smi)


def parallel_gloo_phase(smi: str) -> None:
    import tempfile

    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.parallel import spawn_local

    cfg, tc, params, X_list, Y_list = _flagship_arrays()
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    gen = torch.Generator().manual_seed(SEED + 13)
    offsets = ttrain.draw_offset_stream(gen, sizes, batches, PAR_STEPS)
    timed = ttrain.draw_offset_stream(gen, sizes, batches, PAR_TIMED)
    # the unsharded eager steps of the same state and offsets
    dataset = tp.prepare_dataset_on_device(cfg, X_list, Y_list)
    ext = ttrain.extend_for_wraparound(dataset, batches, sizes)
    step = ttrain.make_step(cfg, tc)
    state = tp.init_train_state(params, cfg, tc)
    scales = ttrain.batch_scales(sizes, batches, cfg.torch_dtype, "cuda")
    eager = []
    for off in offsets.tolist():
        state, metrics = step(state, ttrain.slice_batch(ext, off, sizes,
                                                        batches), scales)
        eager.append(metrics["elbo"])
    eager = torch.stack(eager).double().cpu().numpy()
    del dataset, ext, state
    torch.cuda.synchronize()

    root = tempfile.mkdtemp(prefix="hetmogp_parallel_")
    t0 = time.perf_counter()
    try:
        outs = spawn_local(_parallel_rank, PAR_WORLD, "cuda", "gloo",
                           args=(root, offsets, timed), timeout=PAR_TIMEOUT,
                           deadline=900)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    what = (f"(2, 2) mesh of {PAR_WORLD} gloo ranks sharing the card "
            "(collectives through the host)")
    first_vm = tc.ve_steps_per_vm + 1
    n_vm = sum(1 for i in range(PAR_STEPS) if i % first_vm == tc.ve_steps_per_vm)
    # a rank's latents' (Luu, iLuu)
    want_counts = {"rbf_K_batched_vec": PAR_STEPS, "rbf_backward": n_vm,
                   "tril_projection_tma": (2 + REFRESH_BELOW) * n_vm,
                   "tril_projection_3pass_tma": PAR_STEPS - n_vm,
                   "tril_right_tma": PAR_STEPS + REFRESH_STRIPS * n_vm,
                   "tril_right3_tma": 4 * n_vm, "tril_out3_tma": PAR_STEPS,
                   "rbf_K_batched_scalar": 0, "tril_out_tma": 0,
                   "chol_panel": REFRESH_PANELS * n_vm}
    rows = 6 * TRAIN_B // 2  # a data rank's rows of the VE batch
    rs = refresh_shapes(2)
    want_shapes = {"rbf_K_batched_vec": {(2, rows, M), (2, rows // 4, M)},
                   "tril_projection_3pass_tma": {(2, rows, M)},
                   "tril_projection_tma": ({(2, rows // 4, M)}
                                           | rs["tril_projection_tma"]),
                   # quad_diag in both steps; the adjoints' (M, M) products
                   # and the VM step's Kfubar; the refresh's strips
                   "tril_right_tma": ({(2, rows, M), (2, rows // 4, M)}
                                      | rs["tril_right_tma"]),
                   "chol_panel": rs["chol_panel"],
                   "tril_right3_tma": {(2, M, M), (2, rows // 4, M)},
                   # quad_diag's gL (VE), the solve's Lbar (VM)
                   "tril_out3_tma": {(2, rows, M), (2, rows // 4, M)}}
    # the sharded predictive: a request a task on each rank's rows, after
    # one refresh of its latents' (Luu, iLuu)
    serve_shapes = {k: {(2, PAR_SERVE_ROWS // 2, M)}
                    for k in ("rbf_K_batched_vec", "tril_projection_3pass_tma",
                              "tril_right_tma")}
    serve_shapes["tril_right_tma"] |= rs["tril_right_tma"]
    serve_shapes["tril_projection_tma"] = rs["tril_projection_tma"]
    serve_shapes["chol_panel"] = rs["chol_panel"]
    bad = []
    for r, out in enumerate(outs):
        rel = np.abs(out["elbos"] - eager) / np.abs(eager)
        r_ve, r_all = float(rel[:first_vm].max()), float(rel.max())
        counts = {k: out["counts"][k] for k in want_counts}
        # kernels 6 and 7: each rank takes the likelihood term of the rows
        # of its data rank and updates its own leaves (printed, not held
        # to a count)
        counts.update({k: out["counts"][k] for k in (
            "task_var_exp", "task_var_exp_backward", "gh_sweep",
            "adam_update")})
        shapes = {k: out["shapes"].get(k, set()) for k in want_shapes}
        print(f"{what}, rank {r}: shard rows {out['shard_rows']}, local "
              f"q_sqrt {out['q_sqrt']}, eager steps (captured "
              f"{out['captured']}); ten sharded steps against ten "
              f"unsharded eager steps: {r_ve:.3e} up to the first VM step "
              f"(bound {GRAPH_PLAIN_F32_VE:g}), {r_all:.3e} over all ten "
              f"(bound {GRAPH_PLAIN_F32:g}); launches in the ten steps "
              f"{counts} (per {first_vm}-step cycle, halve them); shapes "
              f"(Q, N, M) {shapes}; collectives {out['collectives']} "
              f"[card: {smi}]")
        print(f"{what}, rank {r}: {out['rate']:.2f} steps/s over a call of "
              f"{PAR_TIMED} steps (four processes time-sharing one card, "
              f"not a scaling number); the gloo all-reduce of a VE step's "
              f"gradient ({out['grad_allreduce'][0]} bytes) over the data "
              f"axis {out['grad_allreduce'][1]:.3f} ms, median of 5; "
              f"sharded fit of {PAR_FIT} steps "
              f"{out['fit_seconds']:.2f} s, ELBO mean of the first ten "
              f"{out['fit_elbo'][0]:.3f}, of the last ten "
              f"{out['fit_elbo'][1]:.3f}; checkpoint step_{PAR_FIT}/ "
              f"{out['ckpt_files']} ({out['ckpt_bytes'] / 2**20:.1f} MiB); "
              f"cut at {PAR_CUT} and resumed to {PAR_FIT} bitwise equal "
              f"{out['resume_bitwise']} [card: {smi}]")
        print(f"{what}, rank {r}: predictive_sharded of 6 x "
              f"{PAR_SERVE_ROWS} rows against make_serving_predictive "
              f"{out['serve_err']:.3e} normwise (bound {PAR_SERVE_BOUND:g}); "
              f"launches {out['serve_counts']} at {out['serve_shapes']}; "
              f"collectives "
              f"{out['serve_collectives']} [card: {smi}]")
        ok = (out["captured"] is False and r_ve <= GRAPH_PLAIN_F32_VE
              and r_all <= GRAPH_PLAIN_F32
              and all(counts[k] == v for k, v in want_counts.items())
              and shapes == want_shapes and out["timed_finite"]
              and out["resume_bitwise"] and out["fit_elbo"][1]
              > out["fit_elbo"][0]
              and out["ckpt_files"] == ["meta.json", "shard_0.npz",
                                        "shard_1.npz"]
              and out["serve_err"] <= PAR_SERVE_BOUND
              and out["serve_finite"]
              and out["serve_counts"]["rbf_K_batched_vec"] == 6
              and out["serve_counts"]["tril_projection_3pass_tma"] == 6
              and out["serve_counts"]["tril_right_tma"]
              == 6 + REFRESH_STRIPS
              and out["serve_counts"]["tril_projection_tma"]
              == REFRESH_BELOW
              and out["serve_counts"]["chol_panel"] == REFRESH_PANELS
              and out["serve_shapes"] == serve_shapes
              and out["serve_collectives"] == [("data", "all_gather"),
                                               ("latent", "all_reduce")])
        if not ok:
            bad.append(r)
    print(f"{what}: the four ranks took {wall:.1f} s from spawn to exit "
          f"[card: {smi}]")
    if bad:
        raise AssertionError(f"the sharded run failed its checks on ranks "
                             f"{bad}")


def parallel_nccl_phase(smi: str) -> None:
    import tempfile

    import torch.distributed as dist

    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.parallel import collectives, sharding

    cfg, tc, params, X_list, Y_list = _flagship_arrays()
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    offsets = ttrain.draw_offset_stream(torch.Generator().manual_seed(
        SEED + 14), sizes, batches, PAR_STEPS)
    store_dir = tempfile.mkdtemp(prefix="hetmogp_nccl_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=PAR_TIMEOUT))
    try:
        mesh = sharding.data_mesh("cuda")
        dataset = tp.prepare_dataset_on_device(cfg, X_list, Y_list)
        shard = tp.prepare_dataset_on_device(cfg, X_list, Y_list, mesh=mesh)
        plain = tp.make_scan_trainer(cfg, tc, sizes, batches,
                                     steps_per_call=GRAPH_CALL_STEPS)
        meshed = tp.make_scan_trainer(cfg, tc, sizes, batches,
                                      steps_per_call=GRAPH_CALL_STEPS,
                                      mesh=mesh)
        s1, e1 = plain(tp.init_train_state(params, cfg, tc), dataset,
                       offsets=offsets)
        ck.zero_launch_counts()
        collectives.zero_collective_counts()
        s2, e2 = meshed(tp.init_train_state(sharding.shard_params(
            mesh, params), cfg, tc, mesh=mesh), shard, offsets=offsets)
        torch.cuda.synchronize()
        replayed = {k: sum(meshed.capture_launches[kind][k]
                           * meshed.replays[kind] for kind in meshed.graphs)
                    for k in ck.launch_counts()}
        captured_colls = collectives.collective_counts()
        bitwise = bool(torch.equal(e1, e2) and all(
            torch.equal(a, b) for a, b in zip(ttrain._state_tensors(s1),
                                              ttrain._state_tensors(s2))))
        what = "world-1 NCCL (\"data\",) mesh, graphed"
        print(f"{what}: captured {meshed.captured}, capture "
              f"{meshed.capture_seconds:.3f} s; ten steps bitwise equal to "
              f"the unsharded make_scan_trainer {bitwise}; kernel launches "
              f"by the replays {replayed}; collectives issued in the warm-up "
              f"and the capture of both graphs {captured_colls} "
              f"[card: {smi}]")
        n_vm = meshed.replays["vm"]
        want = {"rbf_K_batched_vec": PAR_STEPS, "rbf_backward": n_vm,
                "tril_projection_tma": (2 + REFRESH_BELOW) * n_vm,
                "tril_projection_3pass_tma": PAR_STEPS - n_vm,
                "tril_right_tma": PAR_STEPS + REFRESH_STRIPS * n_vm,
                "chol_panel": REFRESH_PANELS * n_vm,
                "tril_right3_tma": 4 * n_vm, "tril_out3_tma": PAR_STEPS,
                "task_var_exp": PAR_STEPS,
                "task_var_exp_backward": PAR_STEPS, "gh_sweep": 0,
                "adam_update": PAR_STEPS}
        if not (meshed.captured and bitwise
                and all(replayed[k] == v for k, v in want.items())
                and captured_colls.get("data.all_reduce", 0) > 0):
            raise AssertionError("the NCCL mesh trainer is not the captured "
                                 "unsharded trainer")
        # steps/s of both, in turns, over calls of GRAPH_CALL_STEPS steps
        gen = torch.Generator().manual_seed(SEED + 15)
        rates = {"unsharded": [], "NCCL mesh": []}
        runs = {"unsharded": (plain, s1, dataset),
                "NCCL mesh": (meshed, s2, shard)}
        for i in range(NCCL_TURNS):
            stream = ttrain.draw_offset_stream(gen, sizes, batches,
                                               GRAPH_CALL_STEPS)
            for name in (("unsharded", "NCCL mesh") if i % 2 == 0
                         else ("NCCL mesh", "unsharded")):
                run, state, ds = runs[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, e = run(state, ds, offsets=stream)
                torch.cuda.synchronize()
                rates[name].append(GRAPH_CALL_STEPS
                                   / (time.perf_counter() - t0))
                if not torch.isfinite(e).all():
                    raise AssertionError(f"{name}: ELBO not finite")
        print(f"{what}: graphed steps/s over calls of {GRAPH_CALL_STEPS} "
              "steps in turns: " + "; ".join(
                  _median_line(k, v, "steps/s") for k, v in rates.items())
              + f" [card: {smi}]")
        del plain, meshed, runs
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)



# ---- kernels 6 and 7: the one-pass GH sweep and the masked adam update ----

# The sweep's row counts: a VE step's task (the bench's batch), a VM
# step's (a quarter), and the six tasks' rows at once.
SWEEP_ROWS = {"VE": TRAIN_B, "VM": TRAIN_B // 4, "fused": 6 * TRAIN_B}
# Kernel 6 in float32 against the plain engine in float64 on the same
# (float32) inputs, normwise per output (value, Ed1, Ed2): at most this
# multiple of the float32 plain engine's own error, plus SWEEP_ABS.  Both
# evaluate the same operations on the same nodes; they differ in the order
# of the node sums (a shuffle tree against cuBLAS's dot) and in the order
# of the derivative products (forward jets against autograd), each a few
# float32 roundings.  A wrong derivative rule or a lost node is off by the
# size of a node's term, orders of magnitude more.
SWEEP_VS_PLAIN = 4.0
SWEEP_ABS = 1e-6
# In float64 against the float64 plain engine: the same few roundings,
# 1e-12 normwise; Gamma's lngamma sweep's Ed2 holds torch's float64
# trigamma (polygamma(1, x), good to ~5e-10 relative), so 1e-8 there.
SWEEP_F64 = 1e-12
SWEEP_F64_LNGAMMA = 1e-8
# The moments of tests/test_torch_families.py's EXTREME_MV (m = -+200, v =
# 50; m = -+20, v = 5) and v = 0: the last rows of every sweep case.
SWEEP_EXTREME_MV = ((-200.0, 50.0), (200.0, 50.0), (-20.0, 5.0),
                    (20.0, 5.0), (0.3, 0.0), (-1.5, 0.0))
# Arithmetic a node of each engine does (the value and its J first and J
# diagonal second derivatives), counted in gh_sweep.cuh with each exp, log,
# lgamma and division one operation and digamma and trigamma's recurrences
# at their shortest: a lower bound on the work, for the bound column.
SWEEP_NODE_OPS = {"bernoulli": 60, "categorical": 150, "lngamma": 80}
SWEEP_NODE_OPS_VALUE = {"bernoulli": 20, "categorical": 20, "lngamma": 25}


def sweep_engines() -> dict:
    """{name: (engine, J, T)}: the three GH engines kernel 6 sweeps on the
    flagship's path, with their latent dimensions and nodes a dimension."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.likelihoods import base, gamma

    return {"bernoulli": (base._var_exp_engine(tp.Bernoulli()), 1, 20),
            "categorical": (base._var_exp_engine(tp.Categorical(K=3)), 2,
                            10),
            "lngamma": (gamma._lngamma_engine(20), 1, 20)}


def sweep_inputs(name: str, J: int, rows: int, seed: int):
    """(Y, m, v) float64 on the card: random moments with the extreme rows
    of SWEEP_EXTREME_MV last, and observations of the family's support."""
    rng = np.random.RandomState(seed)
    ext = len(SWEEP_EXTREME_MV)
    m = 1.5 * rng.randn(rows, J)
    v = 0.01 + 2.0 * rng.rand(rows, J)
    m[-ext:] = np.array([a for a, _ in SWEEP_EXTREME_MV])[:, None]
    v[-ext:] = np.array([b for _, b in SWEEP_EXTREME_MV])[:, None]
    Y = {"bernoulli": lambda: (rng.rand(rows, 1) > 0.5).astype(float),
         "categorical": lambda: rng.randint(1, J + 2, (rows, 1)).astype(
             float),
         "lngamma": lambda: rng.rand(rows, 1)}[name]()
    return tuple(torch.tensor(a, dtype=torch.float64, device="cuda")
                 for a in (Y, m, v))


def sweep_outputs(engine, Y, m, v, use_kernel: bool):
    """(value, Ed1, Ed2) through the engine and autograd, as the trainer
    reaches them: Ed1 = d value / dm, Ed2 = 2 d value / dv."""
    M, V = m.clone().requires_grad_(), v.clone().requires_grad_()
    val = engine(Y, M, V, use_kernel)
    dm, dv = torch.autograd.grad(val.sum(), (M, V))
    return val.detach(), dm, 2.0 * dv


def finite_normwise(a, b) -> float:
    """normwise(a, b) over the entries where b is finite."""
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return normwise(a[fin].double(), b[fin].double())


def sweep_phase(smi: str) -> list:
    """Kernel 6 against the plain engine at the VE, VM and fused row counts
    in float32 and float64 (random and extreme moments), its value-only
    launcher, and its times beside the plain engine and the launch floor;
    then kernel 7 (``adam_phase``).  Returns the kernel entries of rows 6
    and 7."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    engines = sweep_engines()
    abs_err = {}
    for name, (engine, J, T) in engines.items():
        family = quadrature.SWEEP_FAMILIES[name][0]
        for label, rows in SWEEP_ROWS.items():
            Y, m, v = sweep_inputs(name, J, rows, SEED + 30 + rows)
            # float32: inputs rounded once, the references on those values
            Y32, m32, v32 = (a.float() for a in (Y, m, v))
            want = sweep_outputs(engine, Y32.double(), m32.double(),
                                 v32.double(), False)
            plain = sweep_outputs(engine, Y32, m32, v32, False)
            before = ck.gh_sweep.launches
            got = sweep_outputs(engine, Y32, m32, v32, True)
            torch.cuda.synchronize()
            if ck.gh_sweep.launches != before + 1:
                raise AssertionError(f"{name}, {label}: the engine did not "
                                     "launch kernel 6 once")
            nodes, w = quadrature._nodes(T, J, 0, m32)
            alone = ck.gh_sweep_value(family, Y32, m32, v32, nodes, w)
            # the random rows and the extreme ones apart: float32 itself
            # is off at some extremes (Categorical's clip of e^f at m = 200)
            ext = len(SWEEP_EXTREME_MV)
            for what, a, p, b in zip(("value", "Ed1", "Ed2"), got, plain,
                                     want):
                same_nonfinite = torch.equal(torch.isfinite(a),
                                             torch.isfinite(p))
                line = []
                for part, sl in (("random", slice(None, -ext)),
                                 ("extreme", slice(-ext, None))):
                    e_k = finite_normwise(a[sl], b[sl])
                    e_p = finite_normwise(p[sl], b[sl])
                    bound = SWEEP_VS_PLAIN * e_p + SWEEP_ABS
                    line.append(f"{part} rows {e_k:.3e} (the plain f32 "
                                f"engine's {e_p:.3e}, bound {bound:.3e})")
                    if not e_k <= bound:
                        raise AssertionError(
                            f"kernel 6 ({name}, {label}, f32, {part} rows) "
                            f"disagrees with plain: {what}")
                print(f"kernel 6 ({name}, {label} {rows} rows, float32) "
                      f"{what} vs plain f64: {'; '.join(line)}; non-finite "
                      f"where plain f32's are {same_nonfinite} "
                      f"({int((~torch.isfinite(p)).sum())} entries)"
                      f" [card: {smi}]")
                if not same_nonfinite:
                    raise AssertionError(f"kernel 6 ({name}, {label}, f32): "
                                         f"non-finite {what} elsewhere")
            e_alone = finite_normwise(alone, want[0])
            print(f"kernel 6 ({name}, {label}, float32), the value alone "
                  f"(gh_sweep_value): vs plain f64 {e_alone:.3e}, bitwise "
                  f"the derivative launch's value "
                  f"{torch.equal(alone, got[0])} [card: {smi}]")
            if not e_alone <= SWEEP_VS_PLAIN * finite_normwise(
                    plain[0], want[0]) + SWEEP_ABS:
                raise AssertionError(f"kernel 6 ({name}, {label}): the "
                                     "value alone disagrees")
            # float64: the kernel against the plain engine
            want64 = sweep_outputs(engine, Y, m, v, False)
            got64 = sweep_outputs(engine, Y, m, v, True)
            for what, a, b in zip(("value", "Ed1", "Ed2"), got64, want64):
                e = finite_normwise(a, b)
                tol = (SWEEP_F64_LNGAMMA if name == "lngamma"
                       and what == "Ed2" else SWEEP_F64)
                same_nonfinite = torch.equal(torch.isfinite(a),
                                             torch.isfinite(b))
                print(f"kernel 6 ({name}, {label} {rows} rows, float64) "
                      f"{what}: vs plain f64 {e:.3e} (bound {tol:g}); "
                      f"non-finite where plain's are {same_nonfinite}"
                      f" [card: {smi}]")
                if not (e <= tol and same_nonfinite):
                    raise AssertionError(f"kernel 6 ({name}, {label}, f64) "
                                         f"disagrees with plain: {what}")
            # the entries' errors: the kernel against its plain version
            # on the same float32 inputs
            abs_err[name, label] = max(
                float((a - p)[torch.isfinite(p)].abs().max())
                for a, p in zip(got, plain))
            abs_err[name, label, "value"] = float(
                (alone - plain[0])[torch.isfinite(plain[0])].abs().max())
    # times at the VE shape in float32, in turns
    floor = statistics.median(device_times_ms(ck.empty_launch, reps=40))
    entries_t = {}
    for name, (engine, J, T) in engines.items():
        family = quadrature.SWEEP_FAMILIES[name][0]
        rows = SWEEP_ROWS["VE"]
        Y, m, v = (a.float() for a in sweep_inputs(name, J, rows, SEED + 40))
        nodes, w = quadrature._nodes(T, J, 0, m)
        S = nodes.shape[0]
        t, n = time_in_turns({
            "plain": lambda: sweep_outputs(engine, Y, m, v, False),
            "kernel": lambda: ck.gh_sweep(family, Y, m, v, nodes, w),
            "value": lambda: ck.gh_sweep_value(family, Y, m, v, nodes, w),
            "plain value": lambda: engine(Y, m, v, False)})
        nbytes = 4 * (2 * rows * J + rows + S * J + S + rows + 2 * rows * J)
        bound = bound_ms(nbytes, rows * S * SWEEP_NODE_OPS[name], F32_PEAK)
        bound_value = bound_ms(nbytes - 4 * 2 * rows * J,
                               rows * S * SWEEP_NODE_OPS_VALUE[name],
                               F32_PEAK)
        entries_t[name] = (t, bound, bound_value)
        print(f"kernel 6 time ({name}, VE {rows} rows, {S} nodes, float32): "
              f"{t['kernel']:.4f} ms (the value alone {t['value']:.4f} ms, "
              f"bound {bound_value[0]:.6f} ms), the plain engine's forward "
              f"and backward {t['plain']:.4f} ms (the value alone "
              f"{t['plain value']:.4f} ms), empty kernel {floor:.4f} ms; "
              f"bound {bound[0]:.6f} ms ({bound[1]}); no single PyTorch call "
              f"computes it; median of {n} calls each [card: {smi}]")
    # the entries: the VE shape's Categorical sweep, the largest of the
    # three
    t, bound, bound_value = entries_t["categorical"]
    sweep = {"name": "gh_sweep", "route": "cuda",
             "source": "hetmogp_tpu_torch/csrc/gh_sweep_kernel.cu",
             "replaces": "hetmogp_tpu/ops/quadrature.py:129",
             "max_abs_err": abs_err["categorical", "VE"], "ms": t["kernel"],
             "plain_ms": t["plain"], "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None}
    value = dict(sweep, name="gh_sweep_value", ms=t["value"],
                 plain_ms=t["plain value"], bound_ms=bound_value[0],
                 bound_by=bound_value[1],
                 max_abs_err=abs_err["categorical", "VE", "value"])
    table = [entry for name in TASK_TABLES
             for entry in task_time_phase(smi, task_check_phase(smi, name),
                                          name)]
    return [sweep, value, *table, *adam_phase(smi)]


# ---- kernel 6 redesigned: the task table -----------------------------------

# rows a task of the flagship's six tasks: a VE step's batch, a VM step's
# quarter, six batches a task (the fused shape), and a ragged table whose
# masks end in padding (the last fifth of each task's rows masked out)
TASK_ROWS = {"VE": (TRAIN_B,) * 6, "VM": (TRAIN_B // 4,) * 6,
             "fused": (6 * TRAIN_B,) * 6,
             "ragged": (TRAIN_B, 300, 77, TRAIN_B // 4, 1, 1000)}
# and of the ten-family model's table (its four families without theta,
# the multi-term ones, which take instantiations of their own): its VE and
# VM steps' batches
TERM_TASK_ROWS = {"VE": (TRAIN_B,) * 4, "VM": (TRAIN_B // 4,) * 4}
# the task table against the plain term: float32 within SWEEP_VS_PLAIN
# times the plain float32 term's own error against float64 plus SWEEP_ABS,
# float64 within SWEEP_F64, normwise per task and output; c_v (and so dV)
# of the families with an lngamma sweep holds torch's float64 trigamma in
# the plain engine
TASK_F64_TRIGAMMA = SWEEP_F64_LNGAMMA
TASK_TRIGAMMA = ("gamma", "beta", "dirichlet")
# the observations of each family's support, and the extreme rows',
# at and past the closed forms' clips (HetGaussian's squares, Gamma's and
# Exponential's 1e-9 and 1e9) and at the edges of the support (Beta's and
# Dirichlet's near 0 and 1, Binomial's 0 and n, the ZIP's zeros)
TASK_DRAWS = {
    "hetgaussian": lambda rng, n: rng.randn(n, 1),
    "bernoulli": lambda rng, n: (rng.rand(n, 1) > 0.5) * 1.0,
    "categorical": lambda rng, n: rng.randint(1, 4, (n, 1)) * 1.0,
    "poisson": lambda rng, n: rng.poisson(3.0, (n, 1)) * 1.0,
    "gamma": lambda rng, n: rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
    "exponential": lambda rng, n: rng.exponential(1.0, (n, 1)) + 1e-3,
    "beta": lambda rng, n: 0.02 + 0.96 * rng.rand(n, 1),
    "binomial": lambda rng, n: rng.randint(0, 11, (n, 1)) * 1.0,
    "dirichlet": lambda rng, n: rng.dirichlet([2.0, 3.0, 1.5], n),
    "zipoisson": lambda rng, n: rng.poisson(1.0, (n, 1)) * 1.0}
TASK_EXTREME_Y = {
    "hetgaussian": (1e5, -1e5, 0.0, 3.0, 0.5, -0.5),
    "bernoulli": (0, 1, 1, 0, 1, 0), "categorical": (1, 3, 2, 1, 3, 2),
    "poisson": (0, 1e4, 0, 7, 1, 0),
    "gamma": (1e-9, 1e9, 1e-3, 5.0, 1e-9, 1e9),
    "exponential": (1e-9, 1e9, 1e-3, 5.0, 1e-9, 1e9),
    "beta": (1e-3, 0.999, 0.5, 0.02, 0.98, 0.3),
    "binomial": (0, 10, 0, 10, 5, 1),
    "dirichlet": ((1e-3, 1e-3, 0.998), (0.998, 1e-3, 1e-3),
                  (1 / 3, 1 / 3, 1 / 3), (0.6, 0.2, 0.2), (0.05, 0.05, 0.9),
                  (0.2, 0.5, 0.3)),
    "zipoisson": (0, 0, 30, 0, 7, 3)}
# operations a row of a closed form does (the value and its 2J first
# derivatives; the value alone), counted in gh_sweep.cuh as for
# SWEEP_NODE_OPS: lower bounds on the work, for the bound column (Beta's
# and Dirichlet's at least Gamma's; Binomial's and the ZIP's are their
# sweep alone)
TASK_CLOSED_OPS = {"hetgaussian": (60, 20), "poisson": (20, 8),
                   "gamma": (60, 20), "exponential": (20, 8),
                   "beta": (60, 20), "dirichlet": (60, 20)}
# and a node of each term of a multi-term family, in its terms' order
# (lngamma's for an lngamma sum's, Bernoulli's for Binomial's and the
# ZIP's: lower bounds as well)
TASK_TERM_NODE_OPS = {"beta": ((80, 25),) * 3, "binomial": ((60, 20),),
                      "dirichlet": ((80, 25),) * 4, "zipoisson": ((60, 20),)}


def task_liks():
    """The flagship's six likelihoods (``training_arrays``)."""
    return training_arrays()[0].likelihoods


def term_task_liks():
    """The ten-family model's likelihoods that take the task table
    (``families_model``'s without theta)."""
    import hetmogp_tpu_torch as tp

    return (tp.Beta(), tp.Binomial(n=10), tp.Dirichlet(K=3),
            tp.ZeroInflatedPoisson())


# the task tables checked and timed: their likelihoods and rows a task
TASK_TABLES = {"flagship": (task_liks, TASK_ROWS),
               "ten-family": (term_task_liks, TERM_TASK_ROWS)}


def task_inputs(rows, seed: int, extreme: bool, ragged: bool, liks=None):
    """(Y, M, V, masks, scales) of the tasks of ``liks`` (the flagship's
    six by default), float64 on the card: random moments (the last
    len(SWEEP_EXTREME_MV) rows of each task the extreme ones, with
    TASK_EXTREME_Y, when ``extreme``), observations of each family's
    support (TASK_DRAWS), masks of ones (or, ``ragged``, random ones
    and zeros ending in zeros), and the bench's scales N_t / rows.  The
    extreme rows follow random ones: a task of fewer than twice as many
    rows keeps random rows alone, since a task's normwise error is then
    the relative error of its extreme rows alone, and there the value is
    a cancellation (Gamma at m = -200, y = 1e-9: -E[ln Gamma(a)] and
    (E[a] - 1) log y, two terms of 20.7 that meet at 1e-7)."""
    from hetmogp_tpu_torch.ops import quadrature

    rng = np.random.RandomState(seed)
    out = ([], [], [], [])
    for lik, n in zip(task_liks() if liks is None else liks, rows):
        J = lik.dim_f
        name = quadrature.task_family(lik)
        m = 1.5 * rng.randn(n, J)
        v = 0.01 + 2.0 * rng.rand(n, J)
        y = TASK_DRAWS[name](rng, n)
        ext = len(SWEEP_EXTREME_MV)
        if extreme and n >= 2 * ext:
            m[-ext:] = np.array([a for a, _ in SWEEP_EXTREME_MV])[:ext, None]
            v[-ext:] = np.array([b for _, b in SWEEP_EXTREME_MV])[:ext, None]
            y[-ext:] = np.reshape(TASK_EXTREME_Y[name], (ext, -1))
        mask = np.ones(n)
        if ragged:
            mask = (rng.rand(n) > 0.3) * 1.0
            mask[n - n // 5:] = 0.0
        for a, x in zip(out, (y, m, v, mask)):
            a.append(torch.tensor(x, dtype=torch.float64, device="cuda"))
    scales = torch.tensor([TRAIN_N_PER / max(n, 1) for n in rows],
                          dtype=torch.float64, device="cuda")
    return (*out, scales)


def task_plain(liks, Y, M, V, masks, scales, use_kernel=False):
    """The plain term's outputs: (sums, values, c_m, c_v, dM, dV), the
    per-row ones by task; c = the gradient of each task's var_exp sum, d
    that of the sums' total."""
    Ms = [m.clone().requires_grad_() for m in M]
    Vs = [v.clone().requires_grad_() for v in V]
    values, cm, cv = [], [], []
    for lik, y, m, v in zip(liks, Y, Ms, Vs):
        ve = lik.var_exp(y, m, v, use_kernel=use_kernel)
        dm, dv = torch.autograd.grad(ve.sum(), (m, v))
        values.append(ve.detach())
        cm.append(dm)
        cv.append(dv)
    from hetmogp_tpu_torch.ops import quadrature

    sums = quadrature.task_var_exp_plain(liks, Y, Ms, Vs, masks,
                                         list(scales), use_kernel)
    grads = torch.autograd.grad(sums.sum(), Ms + Vs)
    T = len(liks)
    return (sums.detach(), values, cm, cv, list(grads[:T]), list(grads[T:]))


def task_kernel(liks, Y, M, V, masks, scales):
    """The task table's outputs, as ``task_plain``'s: the rows' values and
    coefficients from the forward launcher, the sums and (dM, dV) through
    ``quadrature.task_var_exp`` (a forward and a backward launch, held to
    one each and to the launcher's sums, bitwise)."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    tasks, sc = quadrature._task_launch_args(liks, Y, M, V, masks,
                                             list(scales))
    sums0, values, coefs = ck.task_var_exp(tasks, sc)
    J = [m.shape[1] for m in M]
    Ms = [m.clone().requires_grad_() for m in M]
    Vs = [v.clone().requires_grad_() for v in V]
    before = (ck.task_var_exp.launches, ck.task_var_exp_backward.launches)
    sums = quadrature.task_var_exp(liks, Y, Ms, Vs, masks, list(scales))
    grads = torch.autograd.grad(sums.sum(), Ms + Vs)
    torch.cuda.synchronize()
    if (ck.task_var_exp.launches - before[0],
            ck.task_var_exp_backward.launches - before[1]) != (1, 1):
        raise AssertionError("the task table did not take one forward and "
                             "one backward launch")
    if not torch.equal(sums.detach(), sums0):
        raise AssertionError("the Function's sums are not the launcher's")
    T = len(liks)
    return (sums.detach(), values, [c[:, :j] for c, j in zip(coefs, J)],
            [c[:, j:] for c, j in zip(coefs, J)], list(grads[:T]),
            list(grads[T:]))


TASK_OUTPUTS = ("sum", "value", "c_m", "c_v", "dM", "dV")


def task_errors(got, want, rows_sl=slice(None)):
    """{output: [normwise error a task]} over the entries where ``want``
    is finite (the sums: each task's), and whether the non-finite entries
    agree."""
    errs, same = {}, True
    for name, a, b in zip(TASK_OUTPUTS, got, want):
        if name == "sum":
            pairs = [(a[t:t + 1], b[t:t + 1]) for t in range(a.numel())]
        else:
            pairs = [(x[rows_sl], y[rows_sl]) for x, y in zip(a, b)]
        errs[name] = [finite_normwise(x, y) for x, y in pairs]
        same &= all(torch.equal(torch.isfinite(x), torch.isfinite(y))
                    for x, y in pairs)
    return errs, same


def _fmt(errs) -> str:
    return "; ".join(f"{k} " + " ".join(f"{e:.1e}" for e in v)
                     for k, v in errs.items())


def task_check_phase(smi: str, table: str = "flagship") -> dict:
    """The task table of TASK_TABLES[table] against the plain term at its
    rows in float32 and float64, with random rows and with the extreme
    ones, the value alone bitwise the derivative launch's, two launches
    bitwise equal.  Returns the largest |kernel - plain| of the float32 VE
    case, by launcher."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    make_liks, table_rows = TASK_TABLES[table]
    liks = make_liks()
    trigamma = [quadrature.task_family(lik) in TASK_TRIGAMMA for lik in liks]
    abs_err = {}
    for i, (label, rows) in enumerate(table_rows.items()):
        for extreme in (False, True):
            what = (f"{table}, {label} {rows} rows, "
                    f"{'extreme' if extreme else 'random'}")
            seed = SEED + 70 + 2 * i + extreme + (table != "flagship") * 20
            Y, M, V, masks, scales = task_inputs(
                rows, seed, extreme, label == "ragged", liks)
            # float32: inputs rounded once, the references on those values
            Y32, M32, V32, k32, s32 = (
                [a.float() for a in x] if isinstance(x, list) else x.float()
                for x in (Y, M, V, masks, scales))
            up = ([a.double() for a in x] for x in (Y32, M32, V32, k32))
            want = task_plain(liks, *up, s32.double())
            plain = task_plain(liks, Y32, M32, V32, k32, s32)
            got = task_kernel(liks, Y32, M32, V32, k32, s32)
            again = task_kernel(liks, Y32, M32, V32, k32, s32)
            bitwise = all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                          else all(torch.equal(x, y) for x, y in zip(a, b))
                          for a, b in zip(got, again))
            parts = ((("random rows", slice(None, -len(SWEEP_EXTREME_MV))),
                      ("extreme rows", slice(-len(SWEEP_EXTREME_MV), None)))
                     if extreme else (("all rows", slice(None)),))
            for part, sl in parts:
                e_k, same = task_errors(got, want, sl)
                e_p, _ = task_errors(plain, want, sl)
                _, same_p = task_errors(got, plain, sl)
                ok = same_p and all(
                    a <= SWEEP_VS_PLAIN * b + SWEEP_ABS
                    for k in e_k for a, b in zip(e_k[k], e_p[k]))
                print(f"kernel 6, task table ({what}, {part}, float32) vs "
                      f"plain f64, normwise by task: {_fmt(e_k)}; the plain "
                      f"f32 term's: {_fmt(e_p)}; non-finite where plain "
                      f"f32's are {same_p}; two launches bitwise equal "
                      f"{bitwise} [card: {smi}]")
                if not (ok and bitwise):
                    raise AssertionError(f"the task table ({what}, {part}, "
                                         "f32) disagrees with plain")
            # the value alone: bitwise the derivative launch's
            tasks, sc = quadrature._task_launch_args(liks, Y32, M32, V32,
                                                     k32, list(s32))
            v_sums, v_rows = ck.task_var_exp_value(tasks, sc)
            alone = torch.equal(v_sums, got[0]) and all(
                torch.equal(a, b) for a, b in zip(v_rows, got[1]))
            print(f"kernel 6, task table ({what}, float32), the value "
                  f"alone (task_var_exp_value): sums and rows bitwise the "
                  f"derivative launch's {alone} [card: {smi}]")
            if not alone:
                raise AssertionError("the task table's value alone differs")
            if label == "VE" and not extreme:
                for name, a, b in (("forward", got[1:4], plain[1:4]),
                                   ("backward", got[4:], plain[4:]),
                                   ("value", (v_rows,), (plain[1],))):
                    abs_err[name] = max(
                        float((x - y)[torch.isfinite(y)].abs().max())
                        for xs, ys in zip(a, b) for x, y in zip(xs, ys))
            # float64: the kernel against the plain term
            want64 = task_plain(liks, Y, M, V, masks, scales)
            got64 = task_kernel(liks, Y, M, V, masks, scales)
            e64, same64 = task_errors(got64, want64)
            bad = [(k, t) for k, v in e64.items() for t, e in enumerate(v)
                   if not e <= (TASK_F64_TRIGAMMA if trigamma[t]
                                and k in ("c_v", "dV") else SWEEP_F64)]
            print(f"kernel 6, task table ({what}, float64) vs plain f64, "
                  f"normwise by task: {_fmt(e64)} (bound {SWEEP_F64:g}, "
                  f"c_v and dV of {', '.join(TASK_TRIGAMMA)} "
                  f"{TASK_F64_TRIGAMMA:g}); non-finite where plain's are "
                  f"{same64} [card: {smi}]")
            if bad or not same64:
                raise AssertionError(f"the task table ({what}, f64) "
                                     f"disagrees with plain: {bad}")
    return abs_err


def task_time_phase(smi: str, abs_err: dict, table: str = "flagship") -> list:
    """The times of the task table of TASK_TABLES[table] in float32 at its
    rows but the ragged ones (VE, VM and, for the flagship, fused), in
    turns: the whole term (forward and backward) on the table, on the
    per-engine path (each task's var_exp, kernel 6 per engine for the
    swept ones, torch ops for the closed forms and the sums) and on the
    plain versions, each also as a captured CUDA graph; the three launches
    alone beside the plain term's forward, backward and value; the empty
    kernel.  Returns the kernel entries at VE: the flagship's three
    launchers, the ten-family table's forward and value alone (the
    instantiations that compile the multi-term families in)."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    make_liks, table_rows = TASK_TABLES[table]
    liks = make_liks()
    entries = []
    for label in [k for k in table_rows if k != "ragged"]:
        rows = table_rows[label]
        Y, M, V, masks, scales = (
            [a.float() for a in x] if isinstance(x, list) else x.float()
            for x in task_inputs(rows, SEED + 80, False, False, liks))
        Ms = [m.clone().requires_grad_() for m in M]
        Vs = [v.clone().requires_grad_() for v in V]
        sc = list(scales)
        g = torch.ones(len(liks), device="cuda")

        def term(use_kernel, table):
            # leaves of its own each call: a captured backward must not
            # meet an autograd node made on another stream
            def f():
                fn = (quadrature.task_var_exp if table
                      else quadrature.task_var_exp_plain)
                Ml = [m.detach().requires_grad_() for m in M]
                Vl = [v.detach().requires_grad_() for v in V]
                sums = fn(liks, Y, Ml, Vl, masks, sc, use_kernel=use_kernel)
                return torch.autograd.grad(sums, Ml + Vl, g)
            return f

        def value(use_kernel, table):
            def f():
                with torch.no_grad():
                    fn = (quadrature.task_var_exp if table
                          else quadrature.task_var_exp_plain)
                    return fn(liks, Y, M, V, masks, sc, use_kernel=use_kernel)
            return f

        tasks, _ = quadrature._task_launch_args(liks, Y, M, V, masks, sc)
        _, _, coefs = ck.task_var_exp(tasks, sc)
        recorded = quadrature.task_var_exp_plain(liks, Y, Ms, Vs, masks, sc,
                                                 use_kernel=False)

        def graphed(fn):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            return graph

        graphs = {"table": graphed(term(True, True)),
                  "per-engine path": graphed(term(True, False))}
        fns = {"table": term(True, True),
               "per-engine path": term(True, False),
               "plain": term(False, False),
               "table, graphed": graphs["table"].replay,
               "per-engine path, graphed": graphs["per-engine path"].replay,
               "forward launch": lambda: ck.task_var_exp(tasks, sc),
               "backward launch": lambda: ck.task_var_exp_backward(
                   coefs, masks, sc, g),
               "value launch": lambda: ck.task_var_exp_value(tasks, sc),
               "table value": value(True, True),
               "per-engine path value": value(True, False),
               "plain value": value(False, False),
               "plain forward": lambda: quadrature.task_var_exp_plain(
                   liks, Y, Ms, Vs, masks, sc, use_kernel=False),
               "plain backward": lambda: torch.autograd.grad(
                   recorded, Ms + Vs, g, retain_graph=True),
               "empty kernel": ck.empty_launch}
        t, n = time_in_turns(fns)
        # bytes: y, m, v, the mask and the node tables read, the values,
        # coefficients and sums written; the backward reads the
        # coefficients and masks and writes dM and dV
        N = sum(rows)
        NJ = sum(r * lik.dim_f for r, lik in zip(rows, liks))
        tables = sum(n_.numel() + w_.numel() for _, n_, w_ in
                     quadrature._task_table(liks, M[0]) if n_ is not None)
        fwd_bytes = 4 * (3 * N + 2 * NJ + tables + 2 * NJ + len(rows))
        ops, ops_value = 0, 0
        for lik, r in zip(liks, rows):
            name = quadrature.task_family(lik)
            sweep = quadrature.TASK_FAMILIES[name][2]
            if sweep == quadrature.TERMS:
                sizes = quadrature._task_extras(lik)[0]
                for S, (o, o_value) in zip(sizes, TASK_TERM_NODE_OPS[name]):
                    ops += r * S * o
                    ops_value += r * S * o_value
            elif sweep is not None:
                S = quadrature._task_table([lik], M[0])[0][1].shape[0]
                ops += r * S * SWEEP_NODE_OPS[sweep]
                ops_value += r * S * SWEEP_NODE_OPS_VALUE[sweep]
            if name in TASK_CLOSED_OPS:
                ops += r * TASK_CLOSED_OPS[name][0]
                ops_value += r * TASK_CLOSED_OPS[name][1]
        bound = bound_ms(fwd_bytes, ops, F32_PEAK)
        bound_value = bound_ms(fwd_bytes - 4 * 2 * NJ, ops_value, F32_PEAK)
        bound_bwd = bound_ms(4 * (4 * NJ + N), 2 * NJ + N, F32_PEAK)
        print(f"kernel 6, task table times ({table}, {label}, {N} rows, "
              f"float32), "
              f"median of {n} calls each in turns: the term forward and "
              f"backward on the table {t['table']:.4f} ms (graphed "
              f"{t['table, graphed']:.4f}), on the per-engine path "
              f"{t['per-engine path']:.4f} (graphed "
              f"{t['per-engine path, graphed']:.4f}), plain "
              f"{t['plain']:.4f}; the "
              f"value alone: table {t['table value']:.4f}, per-engine path "
              f"{t['per-engine path value']:.4f}, plain "
              f"{t['plain value']:.4f}; "
              f"launches alone: forward {t['forward launch']:.4f} (bound "
              f"{bound[0]:.6f}, {bound[1]}; plain forward "
              f"{t['plain forward']:.4f}), backward "
              f"{t['backward launch']:.4f} (bound {bound_bwd[0]:.6f}, "
              f"{bound_bwd[1]}; plain backward {t['plain backward']:.4f}), "
              f"value {t['value launch']:.4f} (bound {bound_value[0]:.6f}, "
              f"{bound_value[1]}); empty kernel {t['empty kernel']:.4f} ms"
              f" [card: {smi}]")
        source = "hetmogp_tpu_torch/csrc/ve_tasks_kernel.cu"
        base = {"route": "cuda", "source": source, "library_ms": None}
        if label == "VE" and table != "flagship":
            # the ten-family model's table: the instantiations that compile
            # the multi-term families in
            entries = [
                dict(base, name="task_var_exp_terms",
                     replaces="hetmogp_tpu/ops/quadrature.py:129",
                     max_abs_err=abs_err["forward"],
                     ms=t["forward launch"], plain_ms=t["plain forward"],
                     bound_ms=bound[0], bound_by=bound[1]),
                dict(base, name="task_var_exp_value_terms",
                     replaces="hetmogp_tpu/ops/quadrature.py:121",
                     max_abs_err=abs_err["value"], ms=t["value launch"],
                     plain_ms=t["plain value"], bound_ms=bound_value[0],
                     bound_by=bound_value[1])]
        elif label == "VE":
            entries = [
                dict(base, name="task_var_exp",
                     replaces="hetmogp_tpu/ops/quadrature.py:129",
                     max_abs_err=abs_err["forward"],
                     ms=t["forward launch"], plain_ms=t["plain forward"],
                     bound_ms=bound[0], bound_by=bound[1]),
                dict(base, name="task_var_exp_backward",
                     replaces="hetmogp_tpu/ops/quadrature.py:147",
                     max_abs_err=abs_err["backward"],
                     ms=t["backward launch"], plain_ms=t["plain backward"],
                     bound_ms=bound_bwd[0], bound_by=bound_bwd[1]),
                dict(base, name="task_var_exp_value",
                     replaces="hetmogp_tpu/ops/quadrature.py:121",
                     max_abs_err=abs_err["value"], ms=t["value launch"],
                     plain_ms=t["plain value"], bound_ms=bound_value[0],
                     bound_by=bound_value[1])]
        del graphs
    return entries


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between a and b in units in the last place."""
    if torch.equal(a, b):
        return 0
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return int((a.view(it).long() - b.view(it).long()).abs().max())


def adam_inputs(dtype, seed: int):
    """The flagship's parameters at full width, random moments and
    gradients: (params, AdamState at count 123, grads by leaf name)."""
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.models.params import from_leaves, leaves

    _, tc, params, _ = training_model()
    params = params.to(dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def like(t, scale, positive=False):
        # in t's layout, as a gradient and adam's moments of t are
        r = torch.empty_like(t).normal_(generator=gen)
        return scale * (r.abs() if positive else r)

    opt = ttrain.AdamState(
        torch.full((), 123, dtype=torch.int64, device="cuda"),
        from_leaves(params, [like(t, 0.1) for _, t in leaves(params)]),
        from_leaves(params, [like(t, 0.01, True)
                             for _, t in leaves(params)]))
    grads = {name: like(t, 1.0) for name, t in leaves(params)}
    return tc, params, opt, grads


def adam_phase(smi: str) -> list:
    """Kernel 7 against ``train._adam`` bitwise over the flagship's leaves,
    in a VE and a VM step, float32 and float64, with a float rate and a
    schedule's tensor rate; its time beside _adam and torch._fused_adam_.
    Returns its kernel entry."""
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.models.params import leaves
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    results = {}
    for dtype in (torch.float32, torch.float64):
        tc, params, opt, g = adam_inputs(dtype, SEED + 50)
        sched = ttrain.make_lr_schedule(dataclasses.replace(
            tc, lr_schedule="warmup_cosine",
            lr_schedule_kwargs=(("warmup_steps", 100),
                                ("decay_steps", 1000))))
        rates = {"float 0.005": 0.005,
                 "warmup_cosine tensor": sched(opt.count).to(dtype)}
        for step, free in (("VE", ttrain.ve_mask()),
                           ("VM", ttrain.vm_mask(tc))):
            grads = [g[name] if name in free else None
                     for name, _ in leaves(params)]
            for rate_name, rate in rates.items():
                before = ck.adam_update.launches
                got = ttrain._adam_step(params, opt, grads, rate)
                want = ttrain._adam(params, opt, grads, rate)
                torch.cuda.synchronize()
                if ck.adam_update.launches != before + 1:
                    raise AssertionError("kernel 7 did not launch once")
                pairs = [*zip([t for _, t in leaves(got[0])],
                              [t for _, t in leaves(want[0])]),
                         *zip([t for _, t in leaves(got[1].mu)],
                              [t for _, t in leaves(want[1].mu)]),
                         *zip([t for _, t in leaves(got[1].nu)],
                              [t for _, t in leaves(want[1].nu)])]
                ulps = max(_ulps(a, b) for a, b in pairs)
                count_ok = torch.equal(got[1].count, want[1].count)
                results[dtype, step, rate_name] = ulps
                print(f"kernel 7 vs _adam ({str(dtype)[6:]}, {step} step, "
                      f"{rate_name} rate, count 123): largest difference "
                      f"{ulps} ulp over every leaf, mu and nu (bitwise "
                      f"{ulps == 0}); count {count_ok} [card: {smi}]")
                if ulps != 0 or not count_ok:
                    raise AssertionError("kernel 7 is not _adam to the bit")
    # times in float32 at the float rate, VE and VM steps, in turns
    tc, params, opt, g = adam_inputs(torch.float32, SEED + 51)
    times = {}
    for step, free in (("VE", ttrain.ve_mask()), ("VM", ttrain.vm_mask(tc))):
        grads = [g[name] if name in free else None
                 for name, _ in leaves(params)]
        named = leaves(params)
        idx = [i for i, (name, _) in enumerate(named) if name in free]
        mu = [t for _, t in leaves(opt.mu)]
        nu = [t for _, t in leaves(opt.nu)]
        ps = [named[i][1].clone() for i in idx]  # the leaves' layouts
        gs = [grads[i] for i in idx]
        ms = [mu[i].clone() for i in idx]
        vs = [nu[i].clone() for i in idx]
        steps = [torch.full((), 123.0, device="cuda") for _ in idx]

        def fused():
            torch._fused_adam_(ps, gs, ms, vs, [], steps, lr=0.005,
                               beta1=ttrain.ADAM_B1, beta2=ttrain.ADAM_B2,
                               weight_decay=0.0, eps=ttrain.ADAM_EPS,
                               amsgrad=False, maximize=False)

        t, n = time_in_turns({
            "plain": lambda: ttrain._adam(params, opt, grads, 0.005),
            "kernel": lambda: ttrain._adam_step(params, opt, grads, 0.005),
            "library": fused})
        n_free = sum(named[i][1].numel() for i in idx)
        n_all = sum(t_.numel() for _, t_ in named)
        # free: p, g, mu, nu read, p, mu, nu written; frozen: mu, nu
        nbytes = 4 * (7 * n_free + 4 * (n_all - n_free))
        bound = bound_ms(nbytes, 12 * n_free + 2 * (n_all - n_free),
                         F32_PEAK)
        times[step] = (t, bound)
        print(f"kernel 7 time ({step} step, {n_all} parameters, {n_free} "
              f"free, float32): {t['kernel']:.4f} ms "
              f"({bound[0] / t['kernel'] * 100:.1f}% of the bound), _adam "
              f"{t['plain']:.4f} ms, torch._fused_adam_ over the free leaves "
              f"{t['library']:.4f} ms (it does not decay the frozen leaves' "
              f"moments); bound {bound[0]:.4f} ms ({bound[1]}); median of "
              f"{n} calls each [card: {smi}]")
    t, bound = times["VE"]
    return [{"name": "adam_update", "route": "cuda",
             "source": "hetmogp_tpu_torch/csrc/adam_kernel.cu",
             "replaces": "hetmogp_tpu/train.py:359",
             "max_abs_err": 0.0, "ms": t["kernel"], "plain_ms": t["plain"],
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": t["library"]}]


# the op profile's ranges: the ELBO's likelihood term and the adam update
OP_TERM, OP_ADAM = "hetmogp.likelihood_term", "hetmogp.adam_update"
OP_STEPS = 10  # two VE/VM cycles
# the term's routes: the plain versions; the per-engine path (each
# task's var_exp, kernel 6 per engine for the swept families, torch ops
# for the closed forms and the masked sums); the task table (one launch,
# one for the gradient)
OP_MODES = ("plain", "per-engine path", "task table")


def op_profile_phase(smi: str) -> dict:
    """The flagship's eager step at "high", OP_STEPS steps under
    torch.profiler, once a mode of OP_MODES: the likelihood term on the
    plain versions (and the adam update too), on the per-engine path, and on
    kernel 6's task table (the adam update on kernel 7 in both).  Every
    kernel's device time goes to the torch op that launched it, and each
    op to the likelihood term (launched inside its forward, or by the
    backward of a node its forward made), the adam update, or the rest.
    Returns {mode: {group: (calls, device ms)}}."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.models import elbo as telbo
    from hetmogp_tpu_torch.ops import quadrature

    cfg, tc, params, dataset = training_model(precision="high")
    sizes = (TRAIN_N_PER,) * cfg.num_tasks
    batches = (TRAIN_B,) * cfg.num_tasks
    ext = ttrain.extend_for_wraparound(dataset, batches, sizes)
    gen = torch.Generator().manual_seed(SEED + 60)
    offsets = [ttrain.draw_offsets(gen, sizes, batches)
               for _ in range(OP_STEPS + 5)]
    scales = ttrain.batch_scales(sizes, batches, cfg.torch_dtype, "cuda")
    term, adam_step = telbo.likelihood_term, ttrain._adam_step
    out = {}
    try:
        for mode in OP_MODES:
            seqs = []

            def likelihood_term(params, config, data, moments, scales,
                                use_kernel=True, _mode=mode, _seqs=seqs):
                with torch.profiler.record_function(OP_TERM):
                    # a view's autograd node launches nothing: its sequence
                    # number bounds the term's nodes (numbers between)
                    lo = moments[0][0].view_as(moments[0][0]).grad_fn
                    if _mode == "task table":
                        sums = term(params, config, data, moments, scales,
                                    use_kernel=use_kernel)
                    else:
                        sums = quadrature.task_var_exp_plain(
                            config.likelihoods, [td.Y for td in data],
                            [m for m, _ in moments], [v for _, v in moments],
                            [td.mask for td in data], list(scales),
                            use_kernel=use_kernel and _mode != "plain")
                    hi = sums.view_as(sums).grad_fn
                    _seqs.append((lo._sequence_nr(), hi._sequence_nr()))
                    return sums
            telbo.likelihood_term = likelihood_term

            def adam(params, opt, grads, lr, use_kernel=True, _mode=mode):
                with torch.profiler.record_function(OP_ADAM):
                    return adam_step(params, opt, grads, lr,
                                     use_kernel and _mode != "plain")
            ttrain._adam_step = adam
            step = ttrain.make_step(cfg, tc)
            state = tp.init_train_state(params, cfg)
            for off in offsets[:5]:  # one cycle of warm-up
                state, _ = step(state, ttrain.slice_batch(ext, off, sizes,
                                                          batches), scales)
            seqs.clear()

            def call():
                nonlocal state
                for off in offsets[5:]:
                    state, _ = step(state, ttrain.slice_batch(
                        ext, off, sizes, batches), scales)

            out[mode] = profile_by_op(call, f"eager flagship step "
                                      f"(\"high\", {OP_STEPS} steps), the "
                                      f"likelihood term on the {mode}", smi,
                                      seqs)
    finally:
        telbo.likelihood_term, ttrain._adam_step = term, adam_step
    return out


def profile_by_op(call, what: str, smi: str, seqs) -> dict:
    """Profile ``call`` and give each device activity (kernel, copy, fill)
    to the op whose call launched it: the runtime call of the same
    correlation id, and the op around that call.  An activity belongs to
    the likelihood term when its launch falls inside an OP_TERM range (on
    any thread: the plain engines' autograd runs on the device's thread)
    or under the backward of a node the term's forward made (an autograd
    node whose sequence number lies strictly between the two of a pair of
    ``seqs``, the numbers of a view made just before and just after each
    call of the term), to the adam update inside an
    OP_ADAM range, and to the rest otherwise.  Prints each group's calls
    and device ms and its heaviest ops; returns {group: (calls, ms)}."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from hetmogp_tpu_torch.ops import cuda_kernels

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        cuda_kernels.empty_launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evts = prof.events()
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    term, adam = "likelihood term", "adam"
    # the host's ranges (the profiler also puts each on the device's
    # timeline, as an annotation)
    ranges = {g: [(e.time_range.start, e.time_range.end) for e in evts
                  if e.name == label and e.device_type == cpu]
              for g, label in ((term, OP_TERM), (adam, OP_ADAM))}
    if len(ranges[term]) != len(seqs):
        raise AssertionError(f"{what}: {len(ranges[term])} ranges of the "
                             f"term in the trace, {len(seqs)} calls")

    def in_term(node) -> bool:
        # a backward node's event: its forward thread and sequence number
        n = node.sequence_nr
        return bool(node.fwd_thread) and n >= 0 and any(
            lo < n < hi for lo, hi in seqs)

    launches = {e.id: e for e in evts
                if e.device_type == cpu and e.name.startswith("cu")}
    groups = {term: {}, adam: {}, "rest": {}}
    unlinked = 0
    for k in evts:
        if k.device_type != cuda:
            continue
        launch = launches.get(k.id)
        if launch is None:
            unlinked += 1
            continue
        t = launch.time_range.start
        group = next((g for g, rs in ranges.items()
                      if any(a <= t <= b for a, b in rs)), None)
        parent = launch.cpu_parent
        op = parent.name if parent is not None else launch.name
        while group is None and parent is not None:
            if in_term(parent):
                group = term
            parent = parent.cpu_parent
        ops = groups[group or "rest"]
        calls, ms = ops.get(op, (0, 0.0))
        ops[op] = (calls + 1, ms + (k.time_range.end - k.time_range.start)
                   / 1e3)
    totals = {g: (sum(c for c, _ in ops.values()),
                  sum(ms for _, ms in ops.values()))
              for g, ops in groups.items()}
    busy = sum(ms for _, ms in totals.values())
    if busy <= 0:
        raise AssertionError(f"{what}: the profiler linked no device "
                             "activity to a launch")
    print(f"{what}: {busy:.3f} ms of device time in {wall_ms:.3f} ms of "
          f"traced wall, {sum(c for c, _ in totals.values())} device "
          f"activities ({unlinked} not linked to a launch) [card: {smi}]")
    for g, (calls, ms) in totals.items():
        print(f"  {g}: {calls} device activities, {ms:.3f} ms "
              f"({ms / busy * 100:.1f}%) [card: {smi}]")
        for op, (c, t) in sorted(groups[g].items(),
                                 key=lambda kv: -kv[1][1])[:6]:
            print(f"    {t:8.3f} ms {c:6d}x {op[:70]} [card: {smi}]")
    return totals


def main():
    smi = device_phase()
    build_phase(smi)
    rbf = kernel_phase(smi)
    rbf_backward_phase(smi)
    # the serving and prediction paths before the trainers (see the module
    # docstring)
    served = serving_phase(smi)
    prediction_phase(smi)
    ragged = ragged_serving_phase(smi)
    for k, v in ragged_adjoint_phase(smi).items():
        ragged[k] += v
    Kfu, Luu, iLuu = training_phase(smi)
    proj = projection_phase(smi, Kfu, iLuu)
    proj3 = projection3_phase(smi, Kfu, iLuu)
    right = right_products_phase(smi, Kfu, Luu, iLuu)
    out8 = tril_out_phase(smi, Luu)
    del Kfu, Luu, iLuu
    factor = factor_phase(smi)
    sweep = sweep_phase(smi)
    graphed_parity_phase(smi)
    trajectory_ab_phase(smi)
    # in turns, "highest", "high", "high", "highest", each a fresh trainer:
    # the steps/s of two trainers of one configuration differ by more than
    # the spread within one; the third times five calls, the others three;
    # the last "high" is the main path, the flagship as bench.py runs it
    highest, replayed_highest, _ = graphed_trainer_phase(smi, "highest",
                                                         timed_calls=3)
    graphed_trainer_phase(smi, "high", timed_calls=3)
    counts, replayed, _ = graphed_trainer_phase(smi, "high")
    graphed_trainer_phase(smi, "highest", timed_calls=3)
    mine = ("tril_right_tma", "tril_right3_tma")
    print(f"kernels 4 and 5 on the main path: launches per 5-step cycle "
          f"{ {k: replayed[k] * 5 // GRAPH_CALL_STEPS for k in mine} } (the "
          f"graphed flagship at \"high\"), per serving pass "
          f"{ {k: served[k] for k in mine} } ({6 * N_CHUNKS} requests)"
          f" [card: {smi}]")
    print(f"kernel 8 on the main path: launches per 5-step cycle "
          f"{replayed['tril_out3_tma'] * 5 // GRAPH_CALL_STEPS} of "
          f"tril_out3_tma (the graphed flagship at \"high\"), "
          f"{replayed_highest['tril_out_tma'] * 5 // GRAPH_CALL_STEPS} of "
          f"tril_out_tma (at \"highest\"); none per serving pass "
          f"{ {k: served[k] for k in ('tril_out_tma', 'tril_out3_tma')} }"
          f" [card: {smi}]")
    print(f"kernel 9 on the main path: launches per 5-step cycle "
          f"{replayed['chol_panel'] * 5 // GRAPH_CALL_STEPS} (the graphed "
          f"flagship at \"high\": a refresh's {REFRESH_PANELS} diagonal "
          f"panels), {counts['chol_panel']} in its first call (the init's "
          f"refresh and the capture's); none per serving pass "
          f"{served['chol_panel']} [card: {smi}]")
    mine = ("task_var_exp", "task_var_exp_backward", "task_var_exp_value",
            "gh_sweep", "gh_sweep_value", "adam_update")
    print(f"kernels 6 and 7 on the main path: launches per 5-step cycle "
          f"{ {k: replayed[k] * 5 // GRAPH_CALL_STEPS for k in mine} } (the "
          f"graphed flagship at \"high\"), per serving pass "
          f"{ {k: served[k] for k in mine} } [card: {smi}]")
    op_profile_phase(smi)
    families, families_elbo = families_phase(smi)
    optimizers_phase(smi)
    life = lifecycle_phase(smi)
    parallel_phase(smi)
    # launches: the main path's for the vector RBF kernel and the TMA
    # routes (kernel 8's float32 one from the graphed flagship at
    # "highest", the only precision that runs it); the RBF's scalar
    # kernel never runs at M = 1024, so its are from the ragged serving
    # path and the ragged VM step, its own
    # the task table's value alone runs where an ELBO is evaluated
    # without a gradient: its launches are the lifecycle's (the full-data
    # ELBOs of save and load); the ten-family table's instantiations,
    # those of the ten-family trainer's first call and of its ELBO without
    # a gradient.  The per-engine sweeps run on no main path (every family
    # that sweeps in the flagship and the ten-family models is in the task
    # table): their entries read 0 launches and are off the check below
    kernels = [*rbf, *proj, *proj3, *right, *out8, *sweep, *factor]
    own_path = ("_scalar",)
    off_path = ("gh_sweep", "gh_sweep_value")
    source = {"task_var_exp_value": life, "tril_out_tma": highest,
              "task_var_exp_terms": families,
              "task_var_exp_value_terms": families_elbo}
    for entry in kernels:
        name = entry["name"]
        if name in off_path:
            entry["launches"], entry["main_path"] = 0, False
            continue
        launches = (ragged if name.endswith(own_path)
                    else source.get(name, counts))
        entry["launches"] = launches[name.removesuffix("_terms")]
    if not all(entry["launches"] > 0 for entry in kernels
               if entry.get("main_path", True)):
        raise AssertionError(f"a kernel was not launched on its path: "
                             f"{[(e['name'], e['launches']) for e in kernels]}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
