"""Probe of kernel 9 (the Cholesky factor and inverse of a diagonal panel)
on one H100.

    python3 -m hetmogp_tpu_torch.probes.chol_panel [--against DIR ...]
        [--variant NAME ...] [--widths 1,8,16,...] [--reps 40]

Builds ``csrc/chol_panel_kernel.cu`` of this checkout ("this"), of this
checkout's source rewritten as each ``--variant`` names (``ROOTS``: the
float32 root by ``rsqrtf`` alone, by IEEE ``sqrtf`` and ``1 / d``, by
``rsqrtf`` and one Newton step, or by ``rsqrtf`` with one correction of d
and one of 1 / d, the shipped root) and of each checkout given with
``--against`` (another commit unpacked with ``git archive`` into an
ignored directory, or a directory holding only ``hetmogp_tpu_torch/csrc/``
with one change to the source; named by its directory) with ``nvcc`` at
the package's flags into one shared library each, and a second library of
each with the probe stamps compiled in: ``-DK9_STAMPS`` where the source
has them (``k9s::Stamp``: cycles by role and phase), else the source with
a mark after each ``__syncthreads`` (``MARK_PRELUDE``: the clock64() of
block thread 0 at each block-wide barrier, which splits a design whose
phases end at such barriers).  For each build it prints:

* ``ptxas -v``'s registers, spills, barriers and shared memory of both
  instantiations, their SASS instructions (``cuobjdump -sass``), and the
  dynamic shared memory a launch of 128 asks for;
* whether it holds ``chip_smoke.py``'s bounds at every width of
  ``--widths`` (float32: 4x the plain version's error against float64
  plus 1e-6; float64: 1e-12 from the plain float64 version), exact zeros
  above the diagonal, two launches bitwise equal, and a non-SPD panel's
  NaN (pivots 0, 40 and 127), and its float32 errors at n = 128;
* its time at each width, (4, n, n) float32, and at (4, 128, 128)
  float64: CUDA events behind a device sleep, every build and an empty
  kernel in turns there and back, median, min and max of the calls, and
  whether every call of this checkout beat every call of the other;
* from its stamps build, one launch at each width of ``--stamp-widths``:
  per role and phase, the mean over the blocks in microseconds (cycles at
  the clock that the block's own %globaltimer and clock64() give), the
  kernel's in-block time (%globaltimer, start to end).

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
from pathlib import Path

import torch

from hetmogp_tpu_torch.ops import _build
from hetmogp_tpu_torch.ops import cuda_kernels as ck
from hetmogp_tpu_torch.profiling import (F32_PEAK, bound_ms, card,
                                         device_times_ms)

HERE = Path(__file__).resolve().parents[2]
SOURCE = "chol_panel_kernel.cu"
WIDTHS = (1, 8, 16, 32, 33, 64, 65, 96, 97, 128)
Q = 4
PANEL_VS_PLAIN, PANEL_ABS, PANEL_F64 = 4.0, 1e-6, 1e-12  # chip_smoke.py
# csrc/chol_panel_kernel.cu's k9s::Stamp, in order
STAMPS = ("block", "start ns", "end ns", "pivot: load wait",
          "pivot: ready wait", "pivot: factor",
          "update: factored-block wait (from the load on)",
          "update: a row of the next block (and barrier)",
          "update: look-ahead block and READY",
          "update: the other rows and iL's block row (and barrier)",
          "update: stores", "update: trailing tiles",
          "update: X shares (and barrier)",
          "update: iL block row (its first thread)", "epilogue")
N_STAMPS, FACTOR_0, READY_AT_0, FACT_AT_0 = 32, 20, 24, 28
SUB = 32  # csrc/chol_panel_kernel.cu's sub-panel width
# the float32 root of csrc/chol_panel_kernel.cu::inv_root, and its variants
ROOTS = {"rsqrtf root": "r = rsqrtf(p);\n  d = p * r;",
         "IEEE root": "d = sqrtf(p);\n  r = 1.0f / d;",
         "rsqrtf + Newton root":
         "r = rsqrtf(p);\n  r = r * (1.5f - 0.5f * p * r * r);\n"
         "  d = p * r;",
         "corrected root":
         "r = rsqrtf(p);\n  d = p * r;\n"
         "  d = fmaf(fmaf(-d, d, p), 0.5f * r, d);\n"
         "  r = fmaf(r, fmaf(-d, r, 1.0f), r);"}
MARKS = 64  # the mark build's marks a block
MARK_PRELUDE = r"""
__device__ long long k9_marks[64 * %d];
__device__ __forceinline__ long long k9_ns() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int hetmogp_chol_panel_marks(void* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, k9_marks,
                                   sizeof(long long) * blocks * %d);
}
#define K9_MARK() \
  if (threadIdx.x == 0 && k9_n < %d && blockIdx.x < 64) \
  k9_marks[blockIdx.x * %d + k9_n++] = clock64() - k9_t0
""" % (MARKS, MARKS, MARKS - 4, MARKS)


def marked_source(text: str) -> str:
    """The source with a mark (thread 0's clock64() since the start) after
    each ``__syncthreads();`` of the kernel, the start and end
    %globaltimer in the last two slots."""
    head, sep, rest = text.partition("template <typename T>\n__global__")
    if not sep:
        raise RuntimeError("no kernel template in the source")
    body_start = rest.index("int n) {") + len("int n) {")
    end = rest.index("\ntemplate <typename T>\nint launch(")
    close = rest.rindex("}", 0, end)
    kernel = rest[body_start:close].replace("__syncthreads();",
                                            "__syncthreads(); K9_MARK();")
    begin = ("\n  int k9_n = 0; const long long k9_t0 = clock64();"
             f" if (threadIdx.x == 0 && blockIdx.x < 64)"
             f" k9_marks[blockIdx.x * {MARKS} + {MARKS - 2}] = k9_ns();")
    finish = (f"  if (threadIdx.x == 0 && blockIdx.x < 64) {{"
              f" k9_marks[blockIdx.x * {MARKS} + {MARKS - 4}] ="
              f" clock64() - k9_t0;"
              f" k9_marks[blockIdx.x * {MARKS} + {MARKS - 1}] = k9_ns();"
              f" k9_marks[blockIdx.x * {MARKS} + {MARKS - 3}] = k9_n; }}\n")
    return (head + MARK_PRELUDE + sep + rest[:body_start] + begin + kernel
            + finish + rest[close:])


def variant_source(text: str, name: str) -> str:
    """This checkout's source with its float32 root replaced by
    ``ROOTS[name]``."""
    found = [v for v in ROOTS.values() if text.count(v) == 1]
    if not found:
        raise RuntimeError("the source's float32 root is none of ROOTS")
    return text.replace(max(found, key=len), ROOTS[name])


def slug_of(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")


def start_build(name: str, src: Path, defines=()):
    """Start nvcc on ``src`` into build/hetmogp_tpu_torch/k9probe/<name>/,
    its namespace ``chol_panel`` renamed after ``name``.  Returns (library
    path, process)."""
    slug = slug_of(name)
    out_dir = _build.BUILD_DIR / "k9probe" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "chol_panel.so"
    # each build's C++ names in a namespace of its own: a template's static
    # (launch's attribute flag) is one object across every library of the
    # process otherwise
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-Dchol_panel=k9_{slug}",
           *(f"-D{d}" for d in defines), "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


class Build:
    """Kernel 9's entries of one library."""

    def __init__(self, name: str, lib: Path, log: str):
        self.name, self.log, self.lib = name, log, lib
        so = ctypes.CDLL(str(lib))
        args = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 3 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        self.entry = {}
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(so, f"hetmogp_chol_panel_{tag}")
            fn.argtypes, fn.restype = args, ctypes.c_int
            self.entry[dt] = fn
        self.smem = getattr(so, "hetmogp_chol_panel_smem", None)
        if self.smem is not None:
            self.smem.argtypes, self.smem.restype = [ctypes.c_int] * 2, \
                ctypes.c_int
        self.stamps = getattr(so, "hetmogp_chol_panel_stamps", None)
        self.marks = getattr(so, "hetmogp_chol_panel_marks", None)
        for fn in (self.stamps, self.marks):
            if fn is not None:
                fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], \
                    ctypes.c_int

    def __call__(self, A, L=None, iL=None):
        L = torch.empty_like(A) if L is None else L
        iL = torch.empty_like(A) if iL is None else iL
        stream = torch.cuda.current_stream().cuda_stream
        err = self.entry[A.dtype](
            A.data_ptr(), A.stride(0), A.stride(1), L.data_ptr(), L.stride(0),
            L.stride(1), iL.data_ptr(), iL.stride(0), iL.stride(1),
            A.shape[0], A.shape[-1], stream)
        if err:
            raise RuntimeError(f"{self.name}: launch error {err}")
        return L, iL


def normwise(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


MEMORY_OPS = ("LDS", "STS", "LD", "ST", "LDG", "STG", "LDGSTS", "SHFL",
              "BAR", "SYNCS", "WARPSYNC", "MUFU")


def sass_mix(lib: Path) -> dict:
    """{instantiation: {opcode: count}} of the library's kernels' SASS (the
    opcode with its width suffix, for the memory ops), and "all"."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    mix, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = "float64" if "IdEE" in m.group(1) else "float32"
            mix[name] = {"all": 0}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)", line)
        if name and m:
            op = m.group(1)
            mix[name]["all"] += 1
            if op.split(".")[0] in MEMORY_OPS:
                key = ".".join(t for t in op.split(".")
                               if t in MEMORY_OPS or t in ("64", "128", "U8",
                                                           "E"))
                mix[name][key] = mix[name].get(key, 0) + 1
    return mix


def ptxas_report(b: Build, smi: str) -> None:
    for inst, ops in sass_mix(b.lib).items():
        print(f"  {b.name}, {inst}: SASS instructions {ops.pop('all')}; "
              + ", ".join(f"{k} {v}" for k, v in sorted(ops.items()))
              + f" [card: {smi}]")
    for kernel, line in _build.ptxas_lines(b.log):
        print(f"  {b.name}, {kernel}: ptxas {line} [card: {smi}]")
    if b.smem is not None:
        print(f"  {b.name}: dynamic shared memory at n = 128 "
              f"{b.smem(0, 128)} B (float32), {b.smem(1, 128)} B (float64); "
              f"n = 1 {b.smem(0, 1)} B [card: {smi}]")


def spd(q, n, dtype, gen):
    X = torch.randn(q, n, n + 8, generator=gen, device="cuda",
                    dtype=torch.float64)
    return (X @ X.mT / n + torch.eye(n, device="cuda",
                                     dtype=torch.float64)).to(dtype)


def check(b: Build, widths, gen, smi: str) -> bool:
    ok = True
    worst, at128 = {}, ""
    for dtype in (torch.float32, torch.float64):
        for n in widths:
            A = spd(Q, n, dtype, gen)
            got, again = b(A), b(A)
            plain = ck.chol_panel_plain(A)
            ref = ck.chol_panel_plain(A.double())
            if dtype == torch.float32:
                errs = [normwise(g, r) for g, r in zip(got, ref)]
                plains = [normwise(p, r) for p, r in zip(plain, ref)]
                e = max(errs)
                bound = PANEL_VS_PLAIN * max(plains) + PANEL_ABS
                if n == 128:
                    at128 = (f"; float32 n = 128 normwise vs float64: L "
                             f"{errs[0]:.3e}, iL {errs[1]:.3e} (plain "
                             f"{plains[0]:.3e}, {plains[1]:.3e})")
            else:
                e = max(normwise(g, p) for g, p in zip(got, plain))
                bound = PANEL_F64
            zeros = not any(bool(torch.triu(g, 1).any()) for g in got)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            good = e <= bound and zeros and same
            ok &= good
            k = str(dtype).split(".")[-1]
            worst[k] = max(worst.get(k, 0.0), e / bound)
            if not good:
                print(f"  {b.name}: OFF at {k} n = {n}: error {e:.3e} "
                      f"(bound {bound:.3e}), zeros {zeros}, bitwise {same}")
    rows, cols = torch.tril_indices(128, 128, device="cuda")
    for pivot in (0, 40, 127):
        A = spd(Q, 128, torch.float32, gen)
        A[2, pivot, pivot] = -1.0
        L, iL = b(A)
        nan = (bool(torch.isnan(L[2][rows, cols]).all())
               and not bool(torch.triu(L[2], 1).any())
               and bool(torch.isnan(iL[2]).all())
               and all(bool(torch.isfinite(t[[0, 1, 3]]).all())
                       for t in (L, iL)))
        ok &= nan
        if not nan:
            print(f"  {b.name}: NaN contract OFF at pivot {pivot}")
    print(f"  {b.name}: bounds, zeros, two launches bitwise and NaN at "
          f"widths {list(widths)} {ok} (largest error over its bound: "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + f"){at128} [card: {smi}]")
    return ok


def time_builds(builds, panels: dict, reps: int, smi: str) -> dict:
    """Every build at every case, and the empty kernel, in turns there and
    back: {(build, case): [ms, ...]}."""
    samples = {}
    fns = [(b.name, case, (lambda b=b, A=A: b(A)))
           for case, A in panels.items() for b in builds]
    fns.append(("empty kernel", "", ck.empty_launch))
    for name, case, fn in fns + fns[::-1]:
        samples.setdefault((name, case), []).extend(
            device_times_ms(fn, reps=reps // 2))
    return samples


def stamp_report(b: Build, n: int, gen, smi: str) -> None:
    A = spd(Q, n, torch.float32, gen)
    b(A)
    torch.cuda.synchronize()
    if b.stamps is not None:
        buf = (ctypes.c_longlong * (Q * N_STAMPS))()
        if b.stamps(ctypes.addressof(buf), Q):
            raise RuntimeError(f"{b.name}: reading its stamps failed")
        per = [list(buf[k * N_STAMPS:(k + 1) * N_STAMPS]) for k in range(Q)]
        ghz = statistics.mean(p[0] / max(p[2] - p[1], 1) for p in per)
        us = {name: statistics.mean(p[i] for p in per) / ghz / 1e3
              for i, name in enumerate(STAMPS) if i not in (1, 2)}
        wall = statistics.mean(p[2] - p[1] for p in per) / 1e3
        print(f"  {b.name} stamps, (4, {n}, {n}) float32, mean of the "
              f"blocks at {ghz:.3f} GHz: in-block {wall:.2f} us; "
              + "; ".join(f"{k} {v:.2f}" for k, v in us.items())
              + f" [card: {smi}]")
        subs = -(-n // SUB)
        rows = []
        for s in range(subs):
            rows.append(
                f"s={s}: ready at {statistics.mean(p[READY_AT_0 + s] for p in per) / ghz / 1e3:.2f}, "
                f"factor {statistics.mean(p[FACTOR_0 + s] for p in per) / ghz / 1e3:.2f}, "
                f"factored at {statistics.mean(p[FACT_AT_0 + s] for p in per) / ghz / 1e3:.2f}")
        print(f"  {b.name} chain (us since the block's start): "
              + "; ".join(rows) + f" [card: {smi}]")
    elif b.marks is not None:
        buf = (ctypes.c_longlong * (Q * MARKS))()
        if b.marks(ctypes.addressof(buf), Q):
            raise RuntimeError(f"{b.name}: reading its marks failed")
        per = [list(buf[k * MARKS:(k + 1) * MARKS]) for k in range(Q)]
        count = int(per[0][MARKS - 3])
        wall = statistics.mean(p[MARKS - 1] - p[MARKS - 2] for p in per)
        ghz = statistics.mean(p[MARKS - 4] for p in per) / wall
        marks = [statistics.mean(p[i] for p in per) / ghz / 1e3
                 for i in range(count)]
        steps = [marks[0]] + [b2 - a for a, b2 in zip(marks, marks[1:])]
        print(f"  {b.name} marks, (4, {n}, {n}) float32: in-block "
              f"{wall / 1e3:.2f} us (at {ghz:.3f} GHz); thread 0 at each "
              "__syncthreads, us since the start (the step since the "
              "last): "
              + ", ".join(f"{m:.2f} ({s:.2f})" for m, s in zip(marks, steps))
              + f" [card: {smi}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--variant", action="append", default=[],
                    choices=list(ROOTS))
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--stamp-widths", default="1,32,128")
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probes/chol_panel.py needs a CUDA card")
    smi = card()
    print(f"card: {smi}")
    widths = [int(w) for w in args.widths.split(",")]
    mine = (HERE / "hetmogp_tpu_torch" / "csrc" / SOURCE).read_text()
    trees = [("this", mine)]
    trees += [(f"this, {v}", variant_source(mine, v)) for v in args.variant]
    trees += [(d.name, (d / "hetmogp_tpu_torch" / "csrc" / SOURCE)
               .read_text()) for d in args.against]
    jobs = []
    for name, text in trees:
        src = _build.BUILD_DIR / "k9probe" / f"{slug_of(name)}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)  # the source includes no header of the repo
        jobs.append((name, start_build(name, src)))
        if "K9_STAMPS" in text:
            jobs.append((name + " (stamps)", start_build(
                name + " stamps", src, ("K9_STAMPS",))))
        else:
            marked = src.with_name(f"{slug_of(name)}_marked.cu")
            marked.write_text(marked_source(text))
            jobs.append((name + " (marks)", start_build(name + " marks",
                                                        marked)))
    ck.load()
    builds, stamped = [], []
    for name, (lib, proc) in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed for {name}")
        b = Build(name, lib, log)
        (stamped if name.endswith(")") else builds).append(b)
    for b in builds:
        ptxas_report(b, smi)
    gen = torch.Generator(device="cuda").manual_seed(18)
    ok, failed = True, []
    for b in builds:
        try:
            ok &= check(b, widths, gen, smi)
        except RuntimeError as e:  # a build that cannot launch: say so
            print(f"  {b.name}: {e}; left out of the timing")
            torch.cuda.synchronize()
            failed.append(b)
            ok = False
    builds = [b for b in builds if b not in failed]
    stamped = [b for b in stamped
               if not any(b.name.startswith(f.name + " (") for f in failed)]
    base = spd(Q, 128, torch.float32, gen)
    panels = {f"n = {w}": base[:, :w, :w].contiguous() for w in widths}
    panels["float64 n = 128"] = spd(Q, 128, torch.float64, gen)
    samples = time_builds(builds, panels, args.reps, smi)
    empty = statistics.median(samples[("empty kernel", "")])
    print(f"kernel 9 builds in turns, (4, n, n), device ms: median "
          f"[min, max] of {len(samples[('empty kernel', '')])} calls; "
          f"empty kernel {empty:.4f} [card: {smi}]")
    for case, A in panels.items():
        n = A.shape[-1]
        size = A.element_size()
        bound = bound_ms(size * Q * (n * (n + 1) // 2 + 2 * n * n),
                         2 * Q * n ** 3 / 3, F32_PEAK)[0]
        cells = []
        for b in builds:
            v = samples[(b.name, case)]
            cells.append(f"{b.name} {statistics.median(v):.4f} "
                         f"[{min(v):.4f}, {max(v):.4f}] "
                         f"({bound / statistics.median(v) * 100:.2f}% of "
                         f"{bound:.6f})")
        mine = samples[(builds[0].name, case)]
        beats = [f"every call of this faster than every call of "
                 f"{b.name}: {max(mine) < min(samples[(b.name, case)])}"
                 for b in builds[1:]]
        print(f"  {case}: " + "; ".join(cells + beats) + f" [card: {smi}]")
    for b in stamped:
        for n in (int(w) for w in args.stamp_widths.split(",")):
            stamp_report(b, n, gen, smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
