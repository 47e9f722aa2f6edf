"""Probe of kernel 8 (tril(A^T B)) on one H100.

    python3 -m hetmogp_tpu_torch.probes.tril_out [--against DIR ...]
        [--shapes VE,VM]

Builds ``csrc/tril_out_kernel.cu`` of this checkout ("this") and of each
checkout given with ``--against`` (another commit unpacked with ``git
archive`` into an ignored directory, or a copy of a checkout with one
change to the kernel: a variant; each named by its directory) into one
shared library each, with ``nvcc`` at the package's flags, and, where the
source has them, a second library with the probe stamps compiled in
(``-DK8_STAMPS``).  For each build it prints:

* ``ptxas -v``'s registers, spills and shared memory of the two TMA-fed
  kernels, ``tril_out_tma_kernel`` (float32 FFMA) and
  ``tril_out3_tma_kernel`` (three bf16 ``wgmma`` passes);
* the instruction mix of their loops from ``cuobjdump -sass``
  (``probes/tril_right.py::sass_loops``), the loops with the most FFMA or
  HGMMA first;
* ``clocks.sm`` and the power draw that ``nvidia-smi`` samples while each
  design runs back to back at the VE shape.

Then, at the VE (4, 3072, 1024) and VM (4, 768, 1024) shapes
(``--shapes``), it holds every build's designs to ``chip_smoke.py``'s
bounds (float32: 4x the plain float32 product's error against float64
plus 1e-6; three passes: 16x the plain 3-pass product's error against the
float64 product of the split operands), exact zeros above the diagonal
and REPEAT launches bitwise equal (a tile map of what is off where a
check fails); times every build's designs, cuBLAS's
dense A^T B and mask, in turns there and back behind a device sleep
(median, min and max of the calls, TFLOP/s and the share of the bound),
and says whether every call of this checkout's TMA design was faster
than every call of each other build's; prints each build's schedule; and
from each stamps build, one launch of each TMA design: per block the
cycles its roles spent waiting and working (``tril_out_kernel.cu``'s
``k8s::Stamp``), as mean and max over the blocks, in microseconds at the
sampled clock, and the spread of the blocks' end times.

Each build's SASS is kept beside its library, as
``build/hetmogp_tpu_torch/k4probe/<name>-k8/<source>.sass``.

A measurement script run by hand from the root of a checkout: the
packaging leaves this directory out of an installed ``hetmogp_tpu_torch``.
Needs a CUDA card and the CUDA toolkit; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from hetmogp_tpu_torch.ops import _build
from hetmogp_tpu_torch.ops import cuda_kernels as ck
from hetmogp_tpu_torch.probes.tril_right import (sass, sass_functions,
                                                 sass_loops)
from hetmogp_tpu_torch.profiling import (BF16_PEAK, F32_PEAK, bound_ms, card,
                                         device_times_ms, sampled_clocks)

HERE = Path(__file__).resolve().parents[2]
SOURCE = "tril_out_kernel.cu"
KERNELS = {"f32": "tril_out_tma_kernel", "3pass": "tril_out3_tma_kernel"}
ENTRIES = {"f32": "hetmogp_tril_out_f32", "3pass": "hetmogp_tril_out3_f32"}
SHAPES = {"VE": (4, 3072, 1024), "VM": (4, 768, 1024)}
OUT_VS_PLAIN, OUT_ABS, PROJ3_VS_PLAIN = 4.0, 1e-6, 16.0  # chip_smoke.py
REPEAT = 20  # launches of each design held bitwise equal
# tril_out_kernel.cu's k8s::Stamp, in order (16 a block)
STAMPS = ("block", "stages", "producer wait", "split wait", "split busy",
          "consumer wait", "loop", "flag wait", "fix-up", "partial",
          "epilogue", "start ns", "end ns", "split slot wait")
START_NS, END_NS = 11, 12
N_STAMPS = 16
SMS = 132


def start_build(name: str, tree: Path, source: str, defines=()):
    """Start nvcc on ``tree``'s ``csrc/<source>`` into
    build/hetmogp_tpu_torch/k4probe/<name>/, with ``-D`` of each of
    ``defines``.  Returns (library path, process)."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")
    out_dir = _build.BUILD_DIR / "k4probe" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / Path(source).with_suffix(".so").name
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
           *(f"-D{d}" for d in defines), "-o", str(lib),
           str(tree / "hetmogp_tpu_torch" / "csrc" / source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


class Build:
    """Kernel 8's entries of one checkout's library."""

    def __init__(self, lib: Path):
        so = ctypes.CDLL(str(lib))
        self.lib = so
        self.tma = {}
        for design in ENTRIES:
            fn = getattr(so, ENTRIES[design])
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self.tma[design] = fn
        so.hetmogp_tril_out_partials.argtypes = [ctypes.c_int] * 4
        so.hetmogp_tril_out_partials.restype = ctypes.c_longlong
        so.hetmogp_tril_out_schedule.argtypes = ([ctypes.c_int] * 5
                                                 + [ctypes.c_void_p])
        so.hetmogp_tril_out_schedule.restype = ctypes.c_int
        self.stamps = getattr(so, "hetmogp_tril_out_stamps", None)
        if self.stamps is not None:
            self.stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            self.stamps.restype = ctypes.c_int

    def scratch(self, design, Q, N, M):
        n = self.lib.hetmogp_tril_out_partials(Q, N, M,
                                               int(design == "3pass"))
        return torch.empty(max(n, 1), device="cuda")

    def schedule(self, design, Q, N, M) -> tuple:
        """G, F, rem, P, the busiest block's stages, all blocks' stages,
        the most partial float4s a block reads (an older build reports the
        first six, the seventh 0)."""
        out = (ctypes.c_longlong * 7)()
        self.lib.hetmogp_tril_out_schedule(Q, N, M, int(design == "3pass"),
                                           SMS, out)
        return tuple(out)


def normwise(a, b) -> float:
    return float((a.double() - b).abs().max() / b.abs().max())


def ptxas_report(log: str, n: str, smi: str) -> None:
    kernel = None
    for line in log.splitlines():
        if "entry function" in line:
            kernel = next((k for k in KERNELS.values() if f"'{k}" in line
                           or k in line), None)
        elif kernel and ("registers" in line or "spill" in line):
            print(f"{n}: ptxas, {kernel}: {line.strip()} [card: {smi}]")
        if "warning" in line.lower() or "serializ" in line:
            print(f"{n}: ptxas warning: {line.strip()}")


def tiles_off(got, again, want, b: Build, design: str, Q: int, N: int,
              M: int, what: str) -> None:
    """Which 128 x 128 lower tiles of a failed launch are off from the
    plain version (more than 1e-3 of its largest entry), or differ
    between two launches, and whether each is a split tile of the last
    turn."""
    G, F, rem, P = b.schedule(design, Q, N, M)[:4]
    C, tol = -(-M // 128), 1e-3 * float(want.abs().max())
    off = []
    for q in range(Q):
        for i in range(C):
            for j in range(i + 1):
                sl = (q, slice(128 * i, 128 * i + 128),
                      slice(128 * j, 128 * j + 128))
                e = float((got[sl] - want[sl]).abs().max())
                d = not torch.equal(got[sl], again[sl])
                if e > tol or d:
                    t = q * C * (C + 1) // 2 + i * (i + 1) // 2 + j
                    off.append(f"({q},{i},{j}) {e:.2e}{' varies' if d else ''}"
                               f"{' split' if t >= F * G else ''}")
    print(f"{what}: {len(off)} tiles off: {'; '.join(off[:40])}")


def clock_mhz(text: str) -> float | None:
    m = re.search(r"median (\d+) MHz", text)
    return float(m.group(1)) if m else None


def stamp_report(b: Build, design: str, Q: int, N: int, M: int, mhz: float,
                 what: str, smi: str) -> None:
    """One launch of ``design`` of a stamps build at (Q, N, M): its roles'
    cycles, mean and max over the blocks."""
    G = b.schedule(design, Q, N, M)[0]
    A = torch.randn(Q, N, M, device="cuda")
    B = torch.randn(Q, N, M, device="cuda")
    out = torch.empty(Q, M, M, device="cuda")
    part = b.scratch(design, Q, N, M)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):  # the second launch's stamps, after a warm one
        err = b.tma[design](A.data_ptr(), B.data_ptr(), out.data_ptr(),
                            part.data_ptr(), Q, N, M, stream)
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")
    torch.cuda.synchronize()
    host = (ctypes.c_longlong * (N_STAMPS * G))()
    if b.stamps(host, G):
        raise RuntimeError(f"{what}: stamps not read")
    rows = [host[k * N_STAMPS:(k + 1) * N_STAMPS] for k in range(G)]
    us = (lambda c: c / mhz) if mhz else (lambda c: float("nan"))
    parts = []
    for k, name in enumerate(STAMPS):
        if k in (START_NS, END_NS):
            continue
        v = [r[k] for r in rows]
        if name == "stages":
            parts.append(f"stages mean {statistics.mean(v):.1f} max "
                         f"{max(v)}")
            continue
        parts.append(f"{name} mean {us(statistics.mean(v)):.2f} max "
                     f"{us(max(v)):.2f}")
    t0 = min(r[START_NS] for r in rows)
    ends = sorted((r[END_NS] - t0) / 1e3 for r in rows)
    starts = sorted((r[START_NS] - t0) / 1e3 for r in rows)
    print(f"{what}: stamps over {G} blocks, us at {mhz:.0f} MHz: "
          + "; ".join(parts)
          + f"; starts within {starts[-1]:.2f} us; ends (from the first "
          f"start) min {ends[0]:.2f}, median {statistics.median(ends):.2f}, "
          f"max {ends[-1]:.2f} us [card: {smi}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tril_out probe: no CUDA device")
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
        src = tree / "hetmogp_tpu_torch" / "csrc" / SOURCE
        jobs[n, SOURCE] = start_build(f"{n}-k8", tree, SOURCE)
        if "K8_STAMPS" in src.read_text():
            jobs[n, "stamps"] = start_build(f"{n}-k8-stamps", tree, SOURCE,
                                            ("K8_STAMPS",))
    listings, logs, failed = {}, {}, False
    for key, (lib, proc) in jobs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{key}: nvcc failed ({proc.returncode}):\n{logs[key]}")
            failed = True
            continue
        listings[key] = sass(lib)
    print(f"built {len(listings)} of {len(jobs)} in "
          f"{time.perf_counter() - t0:.1f} s [card: {smi}]")
    builds, stamped = {}, {}
    for n in trees:
        if (n, SOURCE) not in listings:
            continue
        builds[n] = Build(jobs[n, SOURCE][0])
        if (n, "stamps") in listings:
            stamped[n] = Build(jobs[n, "stamps"][0])
        ptxas_report(logs[n, SOURCE], n, smi)
        for design, k in KERNELS.items():
            key = "HGMMA" if design == "3pass" else "FFMA"
            if any(k in f for f in sass_functions(listings[n, SOURCE])):
                for i, mix in enumerate(sass_loops(listings[n, SOURCE], k,
                                                   key=key)[:2]):
                    print(f"{n}: SASS loop {i} of {k}: {mix}")
    if not builds:
        return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    mhz = {}
    for shape_name in args.shapes.split(","):
        Q, N, M = SHAPES[shape_name]
        A = torch.randn(Q, N, M, generator=gen, device="cuda")
        B = torch.randn(Q, N, M, generator=gen, device="cuda")
        out = torch.empty(Q, M, M, device="cuda")
        scratch = {(n, d): b.scratch(d, Q, N, M) for n, b in builds.items()
                   for d in ENTRIES}

        def call(n, design):
            err = builds[n].tma[design](A.data_ptr(), B.data_ptr(),
                                        out.data_ptr(),
                                        scratch[n, design].data_ptr(), Q, N,
                                        M, stream())
            if err:
                raise RuntimeError(f"{n}, {design}: CUDA error {err}")

        ref = torch.tril(A.double().mT @ B.double())
        ahi, alo = (t.double() for t in ck.split_bf16(A))
        bhi, blo = (t.double() for t in ck.split_bf16(B))
        ref_split = torch.tril((alo.mT @ bhi + ahi.mT @ blo) + ahi.mT @ bhi)
        del ahi, alo, bhi, blo
        plain = ck.t_matmul_tril_out_plain(A, B)
        plain3 = ck.t_matmul_tril_out_3pass_plain(A, B)
        e_p, e_p3 = normwise(plain, ref), normwise(plain3, ref_split)
        upper = torch.triu(torch.ones(M, M, dtype=torch.bool,
                                      device="cuda"), 1)
        for n in builds:
            for design in ENTRIES:
                call(n, design)
                got = out.clone()
                twice = True
                for _ in range(REPEAT - 1):
                    call(n, design)
                    twice &= torch.equal(got, out)
                zeros = not bool(got[:, upper].any())
                if design == "3pass":
                    e_k = normwise(got, ref_split)
                    ok = e_k <= PROJ3_VS_PLAIN * e_p3
                    bound = (f"vs f64 of the split operands {e_k:.3e} "
                             f"(plain 3-pass {e_p3:.3e}, bound "
                             f"{PROJ3_VS_PLAIN:g}x)")
                else:
                    e_k = normwise(got, ref)
                    ok = e_k <= OUT_VS_PLAIN * e_p + OUT_ABS
                    bound = (f"vs f64 {e_k:.3e} (plain f32 {e_p:.3e}, bound "
                             f"{OUT_VS_PLAIN:g}x + {OUT_ABS:g})")
                ok = ok and twice and zeros
                failed |= not ok
                print(f"{shape_name}, {n}, {design}: {bound}; zeros "
                      f"above the diagonal {zeros}; {REPEAT} launches "
                      f"bitwise equal {twice}: {'ok' if ok else 'FAILED'}")
                if not ok:
                    want = plain3 if design == "3pass" else plain
                    tiles_off(got, out, want, builds[n], design, Q, N, M,
                              f"{shape_name}, {n}, {design}")
                del got
        del ref, ref_split, plain, plain3, upper

        flop = Q * N * M * (M + 1)
        nbytes = 4 * (2 * A.numel() + Q * M * M)
        bounds = {"f32": bound_ms(nbytes, flop, F32_PEAK),
                  "3pass": bound_ms(nbytes, 3 * flop, BF16_PEAK)}
        timed = {(n, d): (lambda n=n, d=d: call(n, d))
                 for n in builds for d in ENTRIES}
        timed["cuBLAS", "f32"] = lambda: ck.t_matmul_tril_out_plain(A, B)
        samples = {k: [] for k in timed}
        order = list(timed.items())
        for k, f in order + order[::-1]:
            samples[k] += device_times_ms(f)
        print(f"{shape_name} {Q, N, M}: bounds f32 {bounds['f32'][0]:.4f} "
              f"ms ({bounds['f32'][1]}), 3-pass {bounds['3pass'][0]:.4f} "
              f"ms ({bounds['3pass'][1]}); {flop / 1e9:.2f} GFLOP a pass "
              f"[card: {smi}]")
        for (n, d), v in samples.items():
            ms = statistics.median(v)
            print(f"  {n:>12s} {d:5s} {ms:.4f} ms (min {min(v):.4f}, max {max(v):.4f}, "
                  f"{len(v)} calls), {flop / ms / 1e9:.2f} TFLOP/s a pass, "
                  f"{bounds[d][0] / ms * 100:.1f}% of the bound "
                  f"[card: {smi}]")
        for n in builds:
            if n == "this":
                continue
            for d in ENTRIES:
                mine, theirs = samples["this", d], samples[n, d]
                print(f"{shape_name}, {d}: every call of this faster than "
                      f"every call of {n}: {max(mine) < min(theirs)}; "
                      f"median {statistics.median(mine):.4f} against "
                      f"{statistics.median(theirs):.4f} ms "
                      f"({(statistics.median(mine) / statistics.median(theirs) - 1) * 100:+.1f}%)")
        if shape_name == "VE":
            for n in builds:
                for d in ENTRIES:
                    clk = sampled_clocks(lambda n=n, d=d: call(n, d))
                    mhz.setdefault(d, clock_mhz(clk))
                    print(f"{shape_name}, {n}, {d} back to back: {clk} "
                          f"[card: {smi}]")
        for n, b in builds.items():
            for d in ENTRIES:
                G, F, rem, P, busy, total, reads = b.schedule(d, Q, N, M)
                print(f"{shape_name}, {n}, {d}: schedule {G} blocks, {F} "
                      f"whole turns, {rem} tiles in {P} parts, busiest "
                      f"block {busy} stages, balance "
                      f"{total / G / busy:.3f}, fix-up reads a block "
                      f"{reads} float4s")
        del A, B, out, scratch
        torch.cuda.empty_cache()
        for n, b in stamped.items():
            for d in ENTRIES:
                stamp_report(b, d, Q, N, M, mhz.get(d) or 1755.0,
                             f"{shape_name}, {n} (stamps build), {d}", smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
