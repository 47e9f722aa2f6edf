#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hetmogp_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py

It builds the CUDA kernel from ``hetmogp_tpu_torch/csrc/`` (into
``build/hetmogp_tpu_torch/``), checks it against its plain PyTorch version
on the card and times both, then drives the serving path of the bench
serving model at full width (six likelihoods, Q=4, M=1024, Dx=2, float32,
2 chunks of 65536 rows per task), checks what it serves, and times it.
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


def serving_phase(smi: str, device="cuda", m=M, q=Q) -> int:
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.ops import cuda_kernels

    cfg, params, X = serving_model(device, m, q)
    serve = [tp.make_serving_predictive(params, cfg, t)
             for t in range(cfg.num_tasks)]
    chunks = X.split(CHUNK)

    def serve_all():
        return [serve[t](Xc) for t in range(cfg.num_tasks) for Xc in chunks]

    cuda_kernels.rbf_K_batched.launches = 0
    out = serve_all()
    torch.cuda.synchronize()
    launches = cuda_kernels.rbf_K_batched.launches
    rows = cfg.num_tasks * X.shape[0]
    print(f"serving pass: {rows} rows, {len(out)} chunk requests, "
          f"rbf kernel launches {launches}")
    if launches < len(out):
        raise AssertionError("the serving pass did not go through the kernel")
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
    return launches


def main():
    smi = device_phase()
    build_phase()
    kernel = kernel_phase(smi)
    kernel["launches"] = serving_phase(smi)
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
