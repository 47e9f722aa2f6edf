#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hetmogp_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``hetmogp_tpu_torch/csrc/`` (into
``build/hetmogp_tpu_torch/``) and, phase by phase:

1. checks the RBF kernel against its plain PyTorch version and times both;
2. checks the triangular projection kernel against float64 next to cuBLAS,
   on random and on the trainer's real (Kfu, iLuu), and times both;
3. checks the RBF backward (its autograd.Function) against autograd
   through the plain RBF;
4. trains the flagship model of ``bench.py`` at full width (six
   likelihoods, 1e6 rows, Q=4, M=1024, Dx=2, B=512 a task, float32,
   adam, 4 VE steps per VM step): ten steps against the plain versions in
   float32 and float64, the kernels' launches in every step, steps/s over
   five calls of 200 steps, the ELBO, and a profile of one call;
5. serves the bench serving model at full width (2 chunks of 65536 rows
   per task) through both kernels, checks what it serves, and times it.

Every phase raises on failure, so any failure exits non-zero; so does a
machine without CUDA.  The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
TRAIN_CALL_STEPS, TRAIN_CALLS = 200, 5


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
          f"count {torch.cuda.device_count()}")
    return smi


def build_phase():
    from hetmogp_tpu_torch.ops import _build, cuda_kernels

    t0 = time.perf_counter()
    path = _build.build()
    cuda_kernels.load()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def device_times_ms(fn, reps=20, warmup=3):
    """Device time of each of `reps` calls of fn() in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def kernel_phase(smi: str) -> dict:
    from hetmogp_tpu_torch.ops import cuda_kernels

    kern = cuda_kernels.rbf_K_batched
    plain = cuda_kernels.rbf_K_batched_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(q, n, m, dx, iso):
        def u(*shape):
            return torch.rand(*shape, generator=gen, device="cuda")
        return (u(n, dx), u(q, m, dx), 0.2 + 0.1 * u(q, 1 if iso else dx),
                0.5 + u(q))

    cases = {"serving (4, 65536, 1024, Dx=2, ARD)": (Q, CHUNK, M, DX, False),
             "isotropic (4, 5000, 1000, Dx=3)": (4, 5000, 1000, 3, True),
             "ragged (3, 13, 7, Dx=1)": (3, 13, 7, 1, False)}
    errs = {}
    for name, shape in cases.items():
        args = inputs(*shape)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs[name] = err
        print(f"kernel vs plain, {name}: max_abs_err {err:.3e} "
              f"(atol {KERNEL_ATOL:g})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with plain: {name}")
    serving = next(iter(cases))
    args = inputs(*cases[serving])
    # in turns, plain, kernel, kernel, plain, on the same inputs
    p1, k1, k2, p2 = (device_times_ms(lambda f=f: f(*args))
                      for f in (plain, kern, kern, plain))
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    out_bytes = Q * CHUNK * M * 4
    print(f"kernel time at serving shape: {ms:.4f} ms "
          f"({out_bytes / (ms * 1e-3) / 1e12:.3f} TB/s of output), plain "
          f"{plain_ms:.4f} ms; median of {len(k1 + k2)} calls each "
          f"[card: {smi}]")
    return {"name": "rbf_cross_covariance", "route": "cuda",
            "source": "hetmogp_tpu_torch/csrc/rbf_kernel.cu",
            "replaces": "hetmogp_tpu/ops/pallas_kernels.py:43",
            "max_abs_err": errs[serving], "ms": ms, "plain_ms": plain_ms}


def projection_phase(smi: str, Kfu: torch.Tensor, iLuu: torch.Tensor) -> dict:
    """Kernel A against a float64 product next to cuBLAS, and its time."""
    from hetmogp_tpu_torch.ops import cuda_kernels

    kern = cuda_kernels.tril_projection
    plain = cuda_kernels.tril_projection_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def random_case(q, n, m):
        A = torch.randn(q, n, m, generator=gen, device="cuda")
        L = (torch.tril(torch.randn(q, m, m, generator=gen, device="cuda"))
             / m ** 0.5 + 2.0 * torch.eye(m, device="cuda"))
        return A, L

    cases = {"training (4, 3072, 1024)": random_case(Q, 3072, M),
             "serving (4, 65536, 1024)": random_case(Q, CHUNK, M),
             "ragged (3, 1000, 777)": random_case(3, 1000, 777),
             "training Kfu, iLuu of the model": (Kfu, iLuu)}
    errs = {}
    for name, (A, L) in cases.items():
        got = kern(A, L)
        cub = A @ torch.tril(L).mT
        ref = A.double() @ torch.tril(L).double().mT
        scale = ref.abs().max()
        ek = float((got.double() - ref).abs().max() / scale)
        ec = float((cub.double() - ref).abs().max() / scale)
        errs[name] = float((got - cub).abs().max())
        print(f"projection kernel, {name}: normwise error vs f64 {ek:.3e}, "
              f"plain version (cuBLAS) {ec:.3e} (bound {PROJ_VS_CUBLAS:g}x "
              f"plain); max abs difference from plain {errs[name]:.3e}, "
              f"bitwise equal {bool(torch.equal(got, cub))}")
        if not ek <= PROJ_VS_CUBLAS * ec:
            raise AssertionError(f"projection kernel error {ek} > "
                                 f"{PROJ_VS_CUBLAS} x cuBLAS {ec}: {name}")
        del got, cub, ref
    times = {}
    for name in ("training (4, 3072, 1024)", "serving (4, 65536, 1024)"):
        A, L = cases[name]
        Lt = torch.tril(L)
        # in turns: plain, kernel, cuBLAS, cuBLAS, kernel, plain
        p1, k1, c1, c2, k2, p2 = (device_times_ms(lambda f=f: f(A, L))
                                  for f in (plain, kern,
                                            lambda a, _: a @ Lt.mT,
                                            lambda a, _: a @ Lt.mT,
                                            kern, plain))
        q, n, m = A.shape
        flop = q * n * m * (m + 1)  # the triangular FLOPs
        t = {"kernel": statistics.median(k1 + k2),
             "cublas": statistics.median(c1 + c2),
             "plain": statistics.median(p1 + p2)}
        times[name] = t
        print(f"projection time, {name}: kernel {t['kernel']:.4f} ms "
              f"({flop / t['kernel'] / 1e9:.2f} TFLOP/s), cuBLAS "
              f"{t['cublas']:.4f} ms ({flop / t['cublas'] / 1e9:.2f} "
              f"TFLOP/s), plain version {t['plain']:.4f} ms; TFLOP/s on "
              f"Q*N*M*(M+1) = {flop:.3e}; median of {len(k1 + k2)} calls "
              f"each [card: {smi}]")
    train = times["training (4, 3072, 1024)"]
    return {"name": "tril_projection", "route": "cuda",
            "source": "hetmogp_tpu_torch/csrc/tril_proj_kernel.cu",
            "replaces": "tools/probe_pallas_proj.py:20",
            "max_abs_err": errs["training Kfu, iLuu of the model"],
            "ms": train["kernel"], "plain_ms": train["plain"]}


def rbf_backward_phase():
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
              f"{e64:.3e} (bounds {RBF_BWD_F32:g}, {RBF_BWD_F64:g})")
        if not (e32 <= RBF_BWD_F32 and e64 <= RBF_BWD_F64):
            raise AssertionError(f"rbf backward {name} disagrees")


def training_model(device="cuda"):
    """The flagship model and data of bench.py:172-217 at full width: the
    bench's own arrays from RandomState(0), Z = rng.rand(M, 2), lengthscale
    0.2, variance 0.5, q_mu_scale 0.1, jitter 1e-4, float32."""
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
    Z = rng.rand(M, DX).astype(np.float32)
    params = tp.init_params(rng, cfg, Z, lengthscale=0.2, variance=0.5,
                            q_mu_scale=0.1, device=device)
    dataset = tp.make_dataset(X_list, Y_list, cfg, device=device)
    return cfg, tc, params, dataset


def _counts():
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    return (ck.tril_projection.launches, ck.rbf_K_batched.launches,
            ck.RBFCrossCovariance.backwards)


def _zero_counts():
    from hetmogp_tpu_torch.ops import cuda_kernels as ck

    ck.tril_projection.launches = 0
    ck.rbf_K_batched.launches = 0
    ck.RBFCrossCovariance.backwards = 0


def training_phase(smi: str):
    """The flagship trainer: parity, launches, steps/s, ELBO, profile.
    Returns (launch counts of the timed trainer's first call, Kfu, iLuu)."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

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
            state, metrics = step(
                state, ttrain.slice_batch(data, off, sizes, batches), scales)
            out.append(metrics["elbo"])
            if use_kernel:
                tril, rbf, bwd = (a - b for a, b in zip(_counts(), before))
                vm = i % cycle == tc.ve_steps_per_vm
                print(f"  step {i} ({'VM' if vm else 'VE'}): projection "
                      f"kernel launches {tril}, rbf kernel launches {rbf}, "
                      f"rbf backward passes {bwd}")
                if tril < 1 or rbf < 1 or (vm and bwd < 1):
                    raise AssertionError(f"step {i} did not run the kernels")
        elbos[name] = torch.stack(out).double().cpu()
        if name == "kernels":
            trained = state
    def rel(a, b):
        return (elbos[a] - elbos[b]).abs() / elbos[b].abs()

    first_vm = tc.ve_steps_per_vm + 1  # ELBOs before any hyper update
    rel32_ve = float(rel("kernels", "plain_f32")[:first_vm].max())
    rel32 = float(rel("kernels", "plain_f32").max())
    rel64 = float(rel("kernels", "plain_f64").max())
    print("ten steps, ELBO per step: kernels "
          f"{elbos['kernels'].numpy().round(3).tolist()}")
    print(f"  plain f32 {elbos['plain_f32'].numpy().round(3).tolist()}")
    print(f"  plain f64 {elbos['plain_f64'].numpy().round(3).tolist()}")
    print(f"  max relative ELBO difference: vs plain f32 {rel32_ve:.3e} up to "
          f"the first VM step (bound {TRAIN_PLAIN_F32_VE:g}), {rel32:.3e} "
          f"over all ten (bound {TRAIN_PLAIN_F32:g}); vs plain f64 "
          f"{rel64:.3e} (bound {TRAIN_F64:g})")
    if not (torch.isfinite(elbos["kernels"]).all()
            and rel32_ve <= TRAIN_PLAIN_F32_VE and rel32 <= TRAIN_PLAIN_F32
            and rel64 <= TRAIN_F64):
        raise AssertionError("trainer disagrees with its plain versions")

    # the model's own (Kfu, iLuu) at the training shape, for phase 2
    from hetmogp_tpu_torch.ops import kernels
    with torch.no_grad():
        batch = ttrain.slice_batch(ext, offsets[0], sizes, batches)
        p = trained.params
        Kfu = kernels.K_batched("rbf", torch.cat([td.X for td in batch]),
                                p.Z, p.lengthscale, p.variance,
                                use_kernel=False)
        iLuu = trained.iLuu

    # the entry point: one call of 200 steps with the counts from 0
    run = tp.make_trainer(cfg, tc, sizes, batches,
                          steps_per_call=TRAIN_CALL_STEPS)
    state = tp.init_train_state(params, cfg)
    gen = torch.Generator().manual_seed(SEED + 2)
    _zero_counts()
    t0 = time.perf_counter()
    state, first = run(state, dataset, gen)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counts = _counts()
    n_vm = TRAIN_CALL_STEPS // cycle
    print(f"trainer call of {TRAIN_CALL_STEPS} steps (warm-up, {warm:.3f} s):"
          f" projection kernel launches {counts[0]}, rbf kernel launches "
          f"{counts[1]}, rbf backward passes {counts[2]} ({n_vm} VM steps)")
    if (counts[0] < TRAIN_CALL_STEPS or counts[1] < TRAIN_CALL_STEPS
            or counts[2] < n_vm):
        raise AssertionError("the trainer did not go through the kernels")

    calls = [first]
    rates = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_CALLS):
        t0 = time.perf_counter()
        state, e = run(state, dataset, gen)
        torch.cuda.synchronize()
        rates.append(TRAIN_CALL_STEPS / (time.perf_counter() - t0))
        calls.append(e)
    rates.sort()
    med = statistics.median(rates)
    print(f"trainer throughput: {med:.2f} steps/s, median of {TRAIN_CALLS} "
          f"calls of {TRAIN_CALL_STEPS} steps, min {rates[0]:.2f}, max "
          f"{rates[-1]:.2f}, spread {(rates[-1] - rates[0]) / med * 100:.2f}%"
          f"; samples {[round(r, 2) for r in rates]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[card: {smi}]")
    e = torch.cat(calls).double().cpu()
    start, end = float(e[:10].mean()), float(e[-10:].mean())
    print(f"ELBO over {e.numel()} steps: mean of the first ten {start:.3f}, "
          f"of the last ten {end:.3f}, final {float(e[-1]):.3f}")
    if not (torch.isfinite(e).all() and end > start):
        raise AssertionError("ELBO not finite or not rising")

    profile_trainer(cfg, tc, sizes, batches, state, dataset, gen, smi)
    return counts, Kfu, iLuu


def profile_trainer(cfg, tc, sizes, batches, state, dataset, gen, smi):
    """One call of 50 steps under torch.profiler: device idle share and the
    kernels that take the time."""
    import hetmogp_tpu_torch as tp
    from torch.profiler import ProfilerActivity, profile

    run = tp.make_trainer(cfg, tc, sizes, batches, steps_per_call=50)
    state, _ = run(state, dataset, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, dataset, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / 1e3, evt.count, evt.key))
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print("trainer profile: the profiler saw no device time; idle share "
              "not measured")
        return
    print(f"trainer profile, 50 steps: {busy:.3f} ms of kernel time in "
          f"{wall_ms:.3f} ms of traced wall, device idle "
          f"{(1 - busy / wall_ms) * 100:.1f}% [card: {smi}]")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:9.3f} ms {ms / busy * 100:5.1f}% {count:6d}x "
              f"{key[:90]}")


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


def serving_phase(smi: str, device="cuda", m=M, q=Q):
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
    tril, launches, _ = _counts()
    rows = cfg.num_tasks * X.shape[0]
    print(f"serving pass: {rows} rows, {len(out)} chunk requests, "
          f"rbf kernel launches {launches}, projection kernel launches "
          f"{tril}")
    if launches < len(out) or tril < len(out):
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
              f"vs f64 {e64[0]:.3e}, {e64[1]:.3e}")
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


def main():
    smi = device_phase()
    build_phase()
    rbf = kernel_phase(smi)
    rbf_backward_phase()
    counts, Kfu, iLuu = training_phase(smi)
    proj = projection_phase(smi, Kfu, iLuu)
    del Kfu, iLuu
    serving_phase(smi)
    proj["launches"], rbf["launches"] = counts[0], counts[1]
    print(smi)
    print(json.dumps({"kernels": [rbf, proj]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
