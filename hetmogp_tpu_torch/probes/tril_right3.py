"""Probe of kernel 5 (A tril(L) in three bf16 passes) on one H100.

    python3 -m hetmogp_tpu_torch.probes.tril_right3 [--against DIR ...]
        [--shapes VE,VM,adjoint,serving] [--same-sass]

Builds kernel 5 of this checkout ("this") and of each checkout given with
``--against`` (another commit unpacked with ``git archive``, or a copy of
a checkout with one change to the kernel: a variant; each named by its
directory) into one shared library each, with ``nvcc`` at the package's
flags: ``csrc/tril_right3_kernel.cu`` where the checkout has it (its entry
takes a partial-sum scratch), else the TMA design that
``csrc/tril_proj3_kernel.cu`` held before it (its entry runs the split
pre-pass into two bf16 scratch arrays first).  For each build it prints:

* ``ptxas -v``'s registers, spills and shared memory of every kernel, and
  any warning of ptxas about ``wgmma`` (serialized products);
* the instruction mix of the TMA kernel's loops from ``cuobjdump -sass``:
  HGMMA against shared loads (``LDS``), generic loads (``LD.E``), selects
  and integer (address) arithmetic, the loops with the most HGMMA first;
* ``clocks.sm`` and the power draw that ``nvidia-smi`` samples while the
  kernel runs back to back at the VE shape.

Then, at the VE (4, 3072, 1024), VM (4, 768, 1024), adjoint
(4, 1024, 1024) and serving (4, 65536, 1024) shapes (``--shapes``), it
holds every build against the plain 3-pass version and float64 (the
bounds of ``chip_smoke.py``'s ``right_products_phase``: 16x the plain
version's error against the float64 product of the split operands, 1/16
of a 1-pass bf16 product's against the unsplit one), two launches bitwise
equal; and times the builds and the plain version in turns there and back behind a device
sleep: median, min and max of the calls, TFLOP/s and the share of the bf16
bound.  Last, each build's static schedule at the shape on 132 SMs:
blocks, the busiest block's stages over the mean.

``--same-sass`` also builds ``csrc/tril_proj_kernel.cu``,
``csrc/tril_proj3_kernel.cu`` and ``csrc/tril_right_kernel.cu`` (kernels
A, 3 and 4 and kernel 3's split pre-pass) of
every checkout and prints, function by function, whether each one's SASS
is the same as this checkout's.  Functions are matched by their demangled
names without template arguments, so that a kernel that lost its template
parameter is held to the instantiation it was.

Each build's SASS is kept beside its library, as
``build/hetmogp_tpu_torch/k4probe/<name>-k5/<source>.sass``.

A measurement script run by hand from the root of a checkout: the
packaging leaves this directory out of an installed ``hetmogp_tpu_torch``.
Needs a CUDA card and the CUDA toolkit; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import time
from pathlib import Path

import torch

from hetmogp_tpu_torch.ops import cuda_kernels as ck
from hetmogp_tpu_torch.probes.tril_right import (same_sass, sass,
                                                 sass_functions, sass_loops,
                                                 start_build)
from hetmogp_tpu_torch.profiling import (BF16_PEAK, bound_ms, card,
                                         device_times_ms, sampled_clocks)

HERE = Path(__file__).resolve().parents[2]
SOURCE = "tril_right3_kernel.cu"
OLD_SOURCE = "tril_proj3_kernel.cu"  # kernel 5's TMA design before it
KERNELS = ("tril_right3_tma_kernel", "tril_proj3_tma_kernelILb1EE")
SAME_SASS_SOURCES = ("tril_proj_kernel.cu", "tril_proj3_kernel.cu",
                     "tril_right_kernel.cu")
SHAPES = {"VE": (4, 3072, 1024), "VM": (4, 768, 1024),
          "adjoint": (4, 1024, 1024), "serving": (4, 65536, 1024)}
PROJ3_VS_PLAIN, PROJ3_VS_ONE_PASS = 16.0, 1.0 / 16.0  # chip_smoke.py
SMS = 132


class Build:
    """Kernel 5's entries of one checkout's libraries."""

    def __init__(self, tma_lib: Path, new: bool):
        so = ctypes.CDLL(str(tma_lib))
        self.new = new
        self.tma = so.hetmogp_tril_right3_f32
        ptrs = 4 if new else 5  # A, L, out, and partials or hi and lo
        self.tma.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
        self.tma.restype = ctypes.c_int
        self.lib = so
        if new:
            so.hetmogp_tril_right3_partials.argtypes = [ctypes.c_int] * 3
            so.hetmogp_tril_right3_partials.restype = ctypes.c_longlong
            so.hetmogp_tril_right3_schedule.argtypes = (
                [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def scratch(self, Q, N, M):
        """The entry's scratch for (Q, N, M): the partials, or hi and lo."""
        if self.new:
            n = self.lib.hetmogp_tril_right3_partials(Q, N, M)
            return [torch.empty(max(n, 1), device="cuda")]
        return [torch.empty(Q, M, ck.bf16_row(M), dtype=torch.bfloat16,
                            device="cuda") for _ in range(2)]

    def schedule(self, Q, N, M) -> str:
        if not self.new:  # tril_tiles.cuh's snake, 64-deep stages, mirrored
            from hetmogp_tpu_torch.probes.tril_right import schedule_balance
            return schedule_balance(Q, N, M, BK=64)
        out = (ctypes.c_longlong * 4)()
        self.lib.hetmogp_tril_right3_schedule(Q, N, M, SMS, out)
        G, most, total, split = out
        return (f"{G} blocks, split {split}, busiest block {most} stages, "
                f"mean over {SMS} SMs {total / SMS:.1f}: balance "
                f"{total / SMS / most * 100:.1f}%")


def normwise(a, b) -> float:
    return float((a.double() - b).abs().max() / b.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--same-sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tril_right3 probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    trees = {"this": HERE}
    for d in args.against:
        trees[d.resolve().name if d.resolve().name not in trees
              else str(d)] = d.resolve()
    t0 = time.perf_counter()
    jobs = {}
    for n, tree in trees.items():
        new = (tree / "hetmogp_tpu_torch" / "csrc" / SOURCE).exists()
        srcs = {SOURCE if new else OLD_SOURCE,
                *(SAME_SASS_SOURCES if args.same_sass else ())}
        for src in sorted(srcs):
            jobs[n, src] = (new, *start_build(f"{n}-k5", tree, src))
    listings, logs, failed = {}, {}, False
    for (n, src), (_, lib, proc) in jobs.items():
        logs[n, src] = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{n}, {src}: nvcc failed ({proc.returncode}):\n"
                  f"{logs[n, src]}")
            failed = True
            continue
        listings[n, src] = sass(lib)
    print(f"built {len(listings)} of {len(jobs)} in "
          f"{time.perf_counter() - t0:.1f} s [card: {smi}]")
    builds = {}
    for n in trees:
        src = SOURCE if (n, SOURCE) in jobs else OLD_SOURCE
        if (n, src) not in listings:
            continue
        builds[n] = Build(jobs[n, src][1], jobs[n, src][0])
        kernel, entry = None, None
        for line in logs[n, src].splitlines():
            if "entry function" in line:
                entry = line
                kernel = next((k for k in KERNELS if k in line), None)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"{n}: ptxas, {kernel}: {line.strip()} [card: {smi}]")
            if "wgmma" in line and ("serializ" in line
                                    or "warning" in line.lower()):
                print(f"{n}: ptxas warning: {line.strip()} ({entry})")
        for k in KERNELS:
            if any(k in f for f in sass_functions(listings[n, src])):
                for i, mix in enumerate(sass_loops(listings[n, src], k,
                                                   key="HGMMA")[:3]):
                    print(f"{n}: SASS loop {i} of {k}: {mix}")
    if args.same_sass:
        for src in SAME_SASS_SOURCES:
            for n in trees:
                if n != "this" and (n, src) in listings:
                    same_sass(listings.get(("this", src), ""),
                              listings[n, src], n, src)
    if not builds:
        return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for shape_name in args.shapes.split(","):
        Q, N, M = SHAPES[shape_name]
        A = torch.randn(Q, N, M, generator=gen, device="cuda")
        # tril(L) and its upper entries too: the kernels must not read them
        L = (torch.randn(Q, M, M, generator=gen, device="cuda") / M ** 0.5
             + 2.0 * torch.eye(M, device="cuda"))
        out = torch.empty(Q, N, M, device="cuda")
        scratch = {n: b.scratch(Q, N, M) for n, b in builds.items()}

        def call(n):
            err = builds[n].tma(A.data_ptr(), L.data_ptr(), out.data_ptr(),
                                *(s.data_ptr() for s in scratch[n]), Q, N, M,
                                stream())
            if err:
                raise RuntimeError(f"{n}: CUDA error {err}")

        Lt = torch.tril(L)
        plain = ck.matmul_tril_3pass_plain(A, L)
        ahi, alo = (t.double() for t in ck.split_bf16(A))
        lhi, llo = (t.double() for t in ck.split_bf16(Lt))
        ref_split = (alo @ lhi + ahi @ llo) + ahi @ lhi
        del ahi, alo, lhi, llo
        ref = A.double() @ Lt.double()
        one = A.to(torch.bfloat16).float() @ Lt.to(torch.bfloat16).float()
        e_p, f_1 = normwise(plain, ref_split), normwise(one, ref)
        del one
        for n in builds:
            call(n)
            got = out.clone()
            call(n)
            e_k, f_k = normwise(got, ref_split), normwise(got, ref)
            twice = torch.equal(got, out)
            ok = (e_k <= PROJ3_VS_PLAIN * e_p
                  and f_k <= PROJ3_VS_ONE_PASS * f_1 and twice)
            failed |= not ok
            print(f"{shape_name}, {n}: vs f64 of the split operands "
                  f"{e_k:.3e} (plain {e_p:.3e}, bound {PROJ3_VS_PLAIN:g}x); "
                  f"vs f64 {f_k:.3e} (1-pass bf16 {f_1:.3e}, bound "
                  f"{PROJ3_VS_ONE_PASS:g}x); max abs from plain "
                  f"{float((got - plain).abs().max()):.3e}; two launches "
                  f"bitwise equal {twice}: {'ok' if ok else 'FAILED'}")
            del got
        del plain, ref_split, ref

        flop = 3 * Q * N * M * (M + 1)
        b_ms, b_by = bound_ms(4 * (2 * A.numel() + L.numel()), flop,
                              BF16_PEAK)
        timed = {n: (lambda n=n: call(n)) for n in builds}
        timed["plain"] = lambda: ck.matmul_tril_3pass_plain(A, L)
        samples = {k: [] for k in timed}
        order = list(timed.items())
        for k, f in order + order[::-1]:
            samples[k] += device_times_ms(f)
        print(f"{shape_name}: bound {b_ms:.4f} ms ({b_by}, bf16, "
              f"{flop / 1e9:.2f} GFLOP) [card: {smi}]")
        for k, v in samples.items():
            ms = statistics.median(v)
            print(f"  {k:24s} {ms:.4f} ms (min {min(v):.4f}, max "
                  f"{max(v):.4f}, {len(v)} calls), "
                  f"{flop / ms / 1e9:.2f} TFLOP/s, "
                  f"{b_ms / ms * 100:.1f}% of the bound [card: {smi}]")
        if shape_name == "VE":
            for n in builds:
                print(f"{shape_name}, {n} back to back: "
                      f"{sampled_clocks(lambda n=n: call(n))} [card: {smi}]")
        for n, b in builds.items():
            print(f"{shape_name}, {n}: schedule {b.schedule(Q, N, M)}")
        del A, L, Lt, out, scratch
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
