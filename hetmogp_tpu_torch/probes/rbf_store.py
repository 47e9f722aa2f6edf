"""Probe of the RBF kernel's store path on one H100.

    python3 -m hetmogp_tpu_torch.probes.rbf_store

Builds ``probes/rbf_store_probe.cu`` (which includes the package's
``csrc/rbf_kernel.cu``) with ``nvcc`` and times, at the shapes the main
path gives the kernel, in turns there and back behind a device sleep:

* the scalar kernel of the first port,
* the vector kernel (one float4 per thread) at 1 to 32 blocks per SM, with
  plain and with streaming (``st.global.cs``) stores,
* the TMA bulk-store alternative (a double-buffered shared-memory tile that
  one thread hands to ``cp.async.bulk``) at 1 to 3 blocks per SM,
* an empty kernel: the floor under any launch.

Every variant is first held against the plain PyTorch version (2e-6
absolute).  ``VEC_BLOCKS_PER_SM`` in ``csrc/rbf_kernel.cu``, the choice of
float4 stores over the bulk store and the decision to ship no streaming
stores were read off this probe's output; PERF.md section 6 quotes it.
A measurement script run by hand from a checkout: the packaging leaves
this directory out of an installed ``hetmogp_tpu_torch``.  Needs a CUDA
card and the CUDA toolkit; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from hetmogp_tpu_torch.ops import _build, cuda_kernels
from hetmogp_tpu_torch.profiling import HBM_BYTES_PER_S, device_times_ms

SOURCE = Path(__file__).resolve().parent / "rbf_store_probe.cu"
ATOL = 2e-6
SHAPES = {"VE (4, 3072, 1024)": (4, 3072, 1024),
          "VM (4, 768, 1024)": (4, 768, 1024),
          "serving (4, 65536, 1024)": (4, 65536, 1024),
          "projected (4, 2048, 4096)": (4, 2048, 4096)}


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "librbf_store_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode})")
    lib = ctypes.CDLL(str(out))
    ptrs, shape = [ctypes.c_void_p] * 5, [ctypes.c_int] * 5
    lib.probe_rbf_vec.argtypes = ptrs + shape + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.probe_rbf_bulk.argtypes = ptrs + shape + [ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.hetmogp_rbf_cross_f32.argtypes = ptrs + shape + [ctypes.c_void_p]
    lib.hetmogp_empty_launch.argtypes = [ctypes.c_void_p]
    for fn in (lib.probe_rbf_vec, lib.probe_rbf_bulk,
               lib.hetmogp_rbf_cross_f32, lib.hetmogp_empty_launch):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rbf_store probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    for name, (Q, N, M) in SHAPES.items():
        X = torch.rand(N, 2, generator=gen, device="cuda")
        Z = torch.rand(Q, M, 2, generator=gen, device="cuda")
        ls = 0.2 + 0.1 * torch.rand(Q, 2, generator=gen, device="cuda")
        var = 0.5 + torch.rand(Q, generator=gen, device="cuda")
        out = torch.empty(Q, N, M, device="cuda")
        want = cuda_kernels.rbf_K_batched_plain(X, Z, ls, var)
        ptrs = [t.data_ptr() for t in (X, Z, ls, var, out)]

        def call(entry, *knobs):
            err = getattr(lib, entry)(*ptrs, Q, N, M, 2, 2, *knobs, stream())
            if err:
                raise RuntimeError(f"{entry}{knobs}: CUDA error {err}")

        variants = {"scalar": lambda: call("hetmogp_rbf_cross_f32")}
        for bps in (1, 2, 4, 8, 16, 32):
            for hint in (0, 1):
                variants[f"vec bps={bps} cs={hint}"] = (
                    lambda b=bps, h=hint: call("probe_rbf_vec", b, h))
        for bps in (1, 2, 3):
            variants[f"bulk bps={bps}"] = (
                lambda b=bps: call("probe_rbf_bulk", b))
        for key, fn in variants.items():
            out.zero_()
            fn()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if not err <= ATOL:
                raise AssertionError(f"{name}, {key}: max_abs_err {err:.3e}")
        del want
        variants["empty kernel"] = lambda: lib.hetmogp_empty_launch(stream())
        samples = {k: [] for k in variants}
        order = list(variants.items())
        for key, fn in order + order[::-1]:
            samples[key] += device_times_ms(fn, reps=10, warmup=2)
        bound = 4 * (out.numel() + X.numel() + Z.numel() + ls.numel()
                     + var.numel()) / HBM_BYTES_PER_S * 1e3
        print(f"{name}: every variant within {ATOL:g} of plain; bound "
              f"{bound:.4f} ms (bytes) [card: {smi}]")
        for key, v in samples.items():
            ms = statistics.median(v)
            print(f"  {key:18s} {ms:.4f} ms  {bound / ms * 100:5.1f}% of the "
                  f"bound, min {min(v):.4f}, {len(v)} calls [card: {smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
