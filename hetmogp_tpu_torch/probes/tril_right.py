"""Probe of kernel 4 (A tril(L) in float32, quad_diag's row sum) on one H100.

    python3 -m hetmogp_tpu_torch.probes.tril_right [--against DIR ...]
        [--shapes VE,VM,serving,adjoint] [--same-sass]

Builds ``csrc/tril_right_kernel.cu`` of this checkout ("this"), and of
each checkout given with ``--against`` (another commit unpacked with ``git
archive``, or a copy of a checkout with one change to the kernel: a
variant; each named by its directory), into one shared library each, with
``nvcc`` at the package's flags, and for each build prints:

* ``ptxas -v``'s registers, spills and shared memory of every kernel;
* the instruction mix of the TMA kernel's loops from ``cuobjdump -sass``:
  FFMA against shared loads, selects, compares and integer (address)
  arithmetic, loop by loop, the loops with the most FFMA first;
* ``clocks.sm`` and the power draw that ``nvidia-smi`` samples while the
  kernel runs back to back at the VE shape.

Then, at the VE (4, 3072, 1024), VM (4, 768, 1024), serving
(4, 65536, 1024) and adjoint (4, 1024, 1024) shapes (``--shapes``,
comma-separated names) and in each epilogue, it holds every build's
product bitwise against cuBLAS's ``A @ tril(L)`` and its row sums against
float64, and times the builds, cuBLAS (and cuBLAS then square and sum) in
turns there and back behind a device sleep: median, min and max, TFLOP/s
and each time's share of the float32 bound.  Last, the static schedule's
balance at each shape: the work of the busiest block over the mean.

``--same-sass`` also builds ``csrc/tril_proj_kernel.cu`` and
``csrc/tril_proj3_kernel.cu`` (kernel A, kernel 3 and its split pre-pass,
which share ``tril_tma.cuh`` and ``tril_tiles.cuh`` with kernel 4) of
every checkout and prints, function by
function, whether each one's SASS is the same as this checkout's
(``same_sass``).

Each build's SASS is kept beside its library, as
``build/hetmogp_tpu_torch/k4probe/<name>/<source>.sass``.

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
from hetmogp_tpu_torch.profiling import (F32_PEAK, bound_ms, card,
                                         device_times_ms, sampled_clocks)

HERE = Path(__file__).resolve().parents[2]
KERNEL = "tril_right_tma_kernel"
SOURCE = "tril_right_kernel.cu"
# kernels A and 3: the other users of tril_tma.cuh and tril_tiles.cuh
SHARED_HEADER_SOURCES = ("tril_proj_kernel.cu", "tril_proj3_kernel.cu")
SHAPES = {"VE": (4, 3072, 1024), "VM": (4, 768, 1024),
          "serving": (4, 65536, 1024), "adjoint": (4, 1024, 1024)}
EPILOGUES = {"product": 0, "both": 1, "rowsum": 2}
# the row sums against float64, normwise: twice the bound chip_smoke.py
# holds the product to (4x cuBLAS's error)
ROWSUM_VS_CUBLAS = 8.0


def start_build(name: str, tree: Path, source: str):
    """Start nvcc on ``tree``'s ``csrc/<source>`` into
    build/hetmogp_tpu_torch/k4probe/<name>/.  Returns (library path,
    process)."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")
    out_dir = _build.BUILD_DIR / "k4probe" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / Path(source).with_suffix(".so").name
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(tree / "hetmogp_tpu_torch" / "csrc" / source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(lib: Path):
    """The library's entry: A and L, each with its row and plane strides;
    out, partials, r; epilogue; Q, N, M; the stream."""
    fn = ctypes.CDLL(str(lib)).hetmogp_tril_right_strided_f32
    fn.argtypes = (([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ptxas_lines(log: str) -> list:
    """ptxas -v's lines for each kernel: (kernel, line)."""
    rows, kernel = [], None
    for line in log.splitlines():
        if "entry function" in line:
            kernel = re.search(r"'([^']+)'", line)
            kernel = kernel.group(1) if kernel else line.strip()
            kernel = next((k for k in (KERNEL, "row_sum_kernel")
                           if k in kernel), kernel)
        elif kernel and ("registers" in line or "spill" in line):
            rows.append((kernel, line.strip()))
    return rows


def sass(lib: Path) -> str:
    """cuobjdump -sass of ``lib``, also written beside it."""
    text = subprocess.run(
        [str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout
    lib.with_suffix(".sass").write_text(text)
    return text


def sass_functions(listing: str) -> dict:
    """{function name: its SASS} of a cuobjdump -sass listing, the hash of
    each anonymous namespace's name (which differs from build to build)
    taken out."""
    listing = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", listing)
    funcs = re.split(r"\n\s*Function : ", listing)
    return {f.splitlines()[0].strip(): f for f in funcs[1:]}


def demangler(names) -> dict:
    """{mangled: demangled} by the toolkit's cu++filt (names as they are
    where it is missing)."""
    try:
        tool = Path(_build.find_nvcc()).parent / "cu++filt"
    except RuntimeError:  # no toolkit
        return {}
    if not tool.exists() or not names:
        return {}
    out = subprocess.run([str(tool)], input="\n".join(names),
                         capture_output=True, text=True).stdout
    return dict(zip(names, out.splitlines()))


def same_sass(mine: str, theirs: str, name: str, src: str) -> None:
    """Prints, for each function of this checkout's listing, whether the
    one of that name in ``theirs`` has the same SASS; a function that has
    no namesake there is held to those whose names differ from its own
    in template arguments alone."""
    a, b = sass_functions(mine), sass_functions(theirs)
    dm = demangler(sorted(set(a) | set(b)))
    name_of = lambda k: dm.get(k, k)  # noqa: E731
    bare = lambda k: re.sub(r"^void |<[^<>]*>", "", name_of(k))  # noqa: E731
    # the instructions alone, their spacing evened: what follows a
    # function's last one, and the column its encoding is printed at,
    # depend on the rest of the listing
    body = lambda f: [" ".join(ln.split()) for ln in re.findall(  # noqa: E731
        r"/\*[0-9a-f]{4,}\*/[^\n]*|/\* 0x[0-9a-f]+ \*/", f)]
    matched = set()
    for k in sorted(a, key=name_of):
        cands = [k] if k in b else [j for j in b if bare(j) == bare(k)]
        same = [j for j in cands if body(b[j]) == body(a[k])]
        matched.update(same or cands)
        verdict = ("the same" if same else "DIFFERS" if cands
                   else "not found")
        held = f" (as {name_of(same[0])})" if same and same[0] != k else ""
        if cands and not same:  # the first instruction that differs
            x, y = body(a[k]), body(b[cands[0]])
            i = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                     min(len(x), len(y)))
            held = (f" ({len(x)} against {len(y)} lines; first difference "
                    f"at line {i}: {x[i:i + 1]} against {y[i:i + 1]})")
        print(f"SASS of {src}: {name_of(k)}: {verdict} in {name}{held}")
    for j in sorted(set(b) - matched, key=name_of):
        print(f"SASS of {src}: {name_of(j)}: only in {name}")


CLASSES = (("FFMA", r"FFMA"), ("HGMMA", r"HGMMA"), ("LDS", r"LDS"),
           ("LD generic", r"LD"),
           ("global", r"LDG|STG|ST|RED|ATOM"), ("select", r"F?SEL"),
           ("compare", r"[IF]SETP|PLOP3"),
           ("integer", r"IMAD|IADD3|LEA|LOP3|SHF|MOV|IABS|PRMT|SGXT|BMSK|"
                       r"I2F|F2I|VIADD|IMNMX|S2R|S2UR|UMOV|UIADD3|ULEA|"
                       r"ULOP3|USHF|UIMAD|R2UR|CS2R"),
           ("barrier", r"SYNCS|BAR|WARPSYNC|WARPGROUP|NANOSLEEP|MEMBAR|"
                       r"DEPBAR"),
           ("branch", r"BRA|BSSY|BSYNC|EXIT|RET|CALL|JMP"),
           ("other", r".*"))


def _mix(instr) -> dict:
    """Instruction classes (and shared-load widths) of (address, text)."""
    mix = {}
    for _, text in instr:
        op = text.split()[0]
        cls = next(c for c, pat in CLASSES
                   if re.match(rf"(?:{pat})(?:\.|$)", op))
        mix[cls] = mix.get(cls, 0) + 1
        if cls in ("LDS", "LD generic", "other"):
            mix[op] = mix.get(op, 0) + 1
    mix["instructions"] = len(instr)  # the widths and "other" not again
    return mix


def sass_loops(listing: str, kernel: str, key: str = "FFMA") -> list:
    """The loops of ``kernel`` in a cuobjdump -sass listing (each backward
    branch and its target), the most ``key`` instructions first, with
    their mix."""
    body = next((f for name, f in sass_functions(listing).items()
                 if kernel in name), "")
    instr = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        if text:
            instr.append((int(m.group(1), 16), text))
    loops = []
    for addr, text in instr:
        t = re.search(r"0x([0-9a-f]+)", text)
        if text.startswith("BRA") and t and int(t.group(1), 16) <= addr:
            lo = int(t.group(1), 16)
            loops.append({"span": f"{lo:#x}-{addr:#x}",
                          **_mix([i for i in instr if lo <= i[0] <= addr])})
    if not loops:  # no backward branch by address: the whole kernel
        loops = [{"span": "whole kernel", **_mix(instr)}]
    return sorted(loops, key=lambda d: -d.get(key, 0))


def schedule_balance(Q, N, M, sms=132, BM=128, BN=128, BK=32) -> str:
    """The static snake schedule of tril_tiles.cuh (Tiles, make_tiles_on)
    at one block per SM: the busiest block's stages of a 128-row tile over
    the mean block's."""
    R, C = -(-N // BM), -(-M // BN)
    pairs = (C + 1) // 2
    paired = Q * R * pairs >= 2 * sms
    units = Q * R * (pairs if paired else C)
    G = min(units, sms)
    stages = lambda ct: -(-(M - ct * BN) // BK)  # noqa: E731 (mirrored)
    load = [0] * G
    for turn in range(-(-units // G)):
        for b in range(G):
            u = turn * G + (G - 1 - b if turn & 1 else b)
            if u >= units:
                continue
            if paired:
                p = u % pairs
                cts = {C - 1 - p, p}
            else:
                cts = {C - 1 - u // (Q * R)}
            load[b] += sum(stages(C - 1 - ct) for ct in cts)
    mean = sum(load) / sms
    return (f"{'paired' if paired else 'single'} units {units} on {G} "
            f"blocks, busiest block {max(load)} stages, mean over {sms} SMs "
            f"{mean:.1f}: balance {mean / max(load) * 100:.1f}%")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--same-sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tril_right probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    trees = {"this": HERE}
    for d in args.against:
        trees[d.resolve().name if d.resolve().name not in trees
              else str(d)] = d.resolve()
    sources = [SOURCE, *(SHARED_HEADER_SOURCES if args.same_sass else ())]

    t0 = time.perf_counter()
    jobs = {(n, src): start_build(n, tree, src)
            for n, tree in trees.items() for src in sources}
    fns, listings, failed = {}, {}, False
    for (n, src), (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{n}, {src}: nvcc failed ({proc.returncode}):\n{log}")
            failed = True
            continue
        listings[n, src] = sass(lib)
        if src != SOURCE:
            continue
        fns[n] = load(lib)
        for kernel, line in ptxas_lines(log):
            print(f"{n}: ptxas, {kernel}: {line} [card: {smi}]")
        for i, mix in enumerate(sass_loops(listings[n, src], KERNEL)[:3]):
            print(f"{n}: SASS loop {i} of {KERNEL}: {mix}")
    print(f"built {len(listings)} of {len(jobs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for src in sources[1:]:
        for n in trees:
            if n != "this" and (n, src) in listings:
                same_sass(listings.get(("this", src), ""), listings[n, src],
                          n, src)
    if not fns:
        return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for shape_name in args.shapes.split(","):
        Q, N, M = SHAPES[shape_name]
        A = torch.randn(Q, N, M, generator=gen, device="cuda")
        L = (torch.tril(torch.randn(Q, M, M, generator=gen, device="cuda"))
             / M ** 0.5 + 2.0 * torch.eye(M, device="cuda"))
        Lt = torch.tril(L)
        out = torch.empty(Q, N, M, device="cuda")
        # partials: one per 32 columns
        part = torch.empty(Q, N, -(-M // 32), device="cuda")
        r = torch.empty(Q, N, device="cuda")

        def call(fn, mode):
            err = fn(A.data_ptr(), M, N * M, L.data_ptr(), M, M * M,
                     out.data_ptr(), part.data_ptr(), r.data_ptr(), mode, Q,
                     N, M, stream())
            if err:
                raise RuntimeError(f"CUDA error {err}")

        cub = A @ Lt
        ref = A.double() @ Lt.double()
        ref_r = torch.sum(torch.square(ref), dim=-1)
        cub_r = torch.sum(torch.square(cub), dim=-1)
        scale = float(ref.abs().max())
        e_cub = float((cub.double() - ref).abs().max()) / scale
        e_cub_r = float(((cub_r.double() - ref_r).abs().max())
                        / ref_r.abs().max())
        first_r = None
        for n, fn in fns.items():
            call(fn, 0)
            same = torch.equal(out, cub)
            call(fn, 2)
            e_r = float((r.double() - ref_r).abs().max() / ref_r.abs().max())
            r2 = r.clone()
            call(fn, 1)
            same_both = torch.equal(out, cub) and torch.equal(r, r2)
            if first_r is None:
                first_r = (n, r2)
            eq_first = torch.equal(r2, first_r[1])
            ok = (same and same_both
                  and e_r <= ROWSUM_VS_CUBLAS * max(e_cub, e_cub_r))
            failed |= not ok
            print(f"{shape_name}, {n}: product bitwise cuBLAS {same}; row "
                  f"sums vs f64 {e_r:.3e} (cuBLAS then square and sum "
                  f"{e_cub_r:.3e}, product {e_cub:.3e}), bitwise "
                  f"{first_r[0]}'s {eq_first}; \"both\" bitwise the other "
                  f"two {same_both}: {'ok' if ok else 'FAILED'}")
        del ref, ref_r, cub_r

        flop = Q * N * M * (M + 1)
        for ep, mode in EPILOGUES.items():
            outb = 4 * Q * N * {"product": M, "both": M + 1, "rowsum": 1}[ep]
            b_ms, b_by = bound_ms(4 * (A.numel() + L.numel()) + outb, flop,
                                  F32_PEAK)
            timed = {n: (lambda fn=fn, mode=mode: call(fn, mode))
                     for n, fn in fns.items()}
            if ep == "product":
                timed["cuBLAS"] = lambda: torch.matmul(A, Lt, out=out)
            else:
                timed["cuBLAS, square, sum"] = lambda: torch.sum(
                    torch.square(A @ Lt), dim=-1)
            samples = {k: [] for k in timed}
            order = list(timed.items())
            for k, f in order + order[::-1]:
                samples[k] += device_times_ms(f)
            print(f"{shape_name}, \"{ep}\": bound {b_ms:.4f} ms ({b_by}, "
                  f"{flop / 1e9:.2f} GFLOP) [card: {smi}]")
            for k, v in samples.items():
                ms = statistics.median(v)
                print(f"  {k:24s} {ms:.4f} ms (min {min(v):.4f}, max "
                      f"{max(v):.4f}, {len(v)} calls), "
                      f"{flop / ms / 1e9:.2f} TFLOP/s, "
                      f"{b_ms / ms * 100:.1f}% of the bound [card: {smi}]")
        if shape_name == "VE":
            for n, fn in fns.items():
                print(f"{shape_name}, {n}, \"product\" back to back: "
                      f"{sampled_clocks(lambda fn=fn: call(fn, 0))} "
                      f"[card: {smi}]")
            print(f"{shape_name}, cuBLAS back to back: "
                  f"{sampled_clocks(lambda: torch.matmul(A, Lt, out=out))}"
                  f" [card: {smi}]")
        print(f"{shape_name}: schedule {schedule_balance(Q, N, M)}")
        del A, L, Lt, out, part, r, cub
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
