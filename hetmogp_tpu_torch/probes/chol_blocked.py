"""Probe of kernel 10 (the blocked Cholesky factor and inverse of a stack
in one persistent launch) on one H100.

    python3 -m hetmogp_tpu_torch.probes.chol_blocked [--check]
        [--times] [--stamps] [--shapes 4x1024,8x1024]
        [--reps 40]

``--check``: ptxas's registers, spills and shared memory of the package's
build of ``chol_blocked_kernel``, then ``linalg.blocked_cholesky_inverse``
at each shape and at (4, 777, 777) (padded) and (2, 4096, 4096): L's and
iL's normwise errors against float64 beside ``potrf``'s and ``trsm``'s,
exact zeros above the diagonal, two calls bitwise equal, a stack's parts
bitwise the parts alone, a CUDA graph's replay bitwise the eager call, and
NaN from a failing panel on.

``--times``: the pair at each shape as a replayed CUDA graph (the way the
trainer runs it), beside ``cholesky_ex`` and ``solve_triangular`` against
I (the library's yardstick) and an empty kernel: CUDA events behind a
device sleep, in turns there and back, medians.  It runs whatever route
the checkout's ``linalg`` takes, so run in a parent checkout (with
``PYTHONPATH`` at it) it times the chain of launches kernel 10 replaced.

``--stamps``: ``csrc/chol_blocked_kernel.cu`` built alone with nvcc at the
package's flags and ``-DK10_STAMPS``, launched on the flagship's Kuu stack
at each shape: the call's time between its first ticket and its last
task's end (%globaltimer), the critical path per panel (matrix 0:
POTRF(p)'s end to POTRF(p + 1)'s end, with the POTRF's own time and the
wait before it; the row parts of the TRSM and UPD between them), the
inverse's tail after the last POTRF, the SMs' busy share (the union of
task intervals on each SM over the call's SMs times its time) and each
kind's mean task time; and the stamp build's time per call.

A measurement script run by hand from the root of a checkout: the
packaging leaves this directory out of an installed ``hetmogp_tpu_torch``.
Needs a CUDA card and the CUDA toolkit; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

from hetmogp_tpu_torch.ops import _build
from hetmogp_tpu_torch.ops import cuda_kernels as ck
from hetmogp_tpu_torch.profiling import (F32_PEAK, bound_ms, card,
                                         device_times_ms)

TILE = 128
KINDS = ("POTRF", "TRSM", "UPD", "ACC", "INV")
PER_TASK = 6  # csrc/chol_blocked_kernel.cu: k10s::PER_TASK


def normwise(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def shapes_of(text: str):
    return [tuple(int(v) for v in s.split("x")) for s in text.split(",")]


def kuu(q: int, m: int) -> torch.Tensor:
    """The flagship's Kuu + jitter for q latents at m inducing points, as
    ``chip_smoke.flagship_kuu`` builds it."""
    import chip_smoke

    return chip_smoke.flagship_kuu(m=m, q=q)


def stack(q: int, m: int) -> torch.Tensor:
    """q matrices at width m: the flagship's Kuu repeated (the exact
    natural-gradient step stacks two sets of Q = 4)."""
    K = kuu(4, m)
    return K.repeat((q + 3) // 4, 1, 1)[:q].contiguous()


def in_turns(fns: dict, reps: int):
    samples = {k: [] for k in fns}
    order = list(fns.items())
    for k, f in order + order[::-1]:
        samples[k] += device_times_ms(f, reps=reps)
    return {k: (statistics.median(v), min(v), max(v))
            for k, v in samples.items()}


def graphed(fn):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g


def check(shapes, smi: str) -> bool:
    from hetmogp_tpu_torch.ops import linalg

    log = _build.library_path().with_suffix(".log").read_text()
    for kernel, line in _build.ptxas_lines(log):
        if kernel.startswith("chol_blocked_kernel"):
            print(f"kernel 10, ptxas, {kernel}: {line} [card: {smi}]")
    print(f"kernel 10: {ck._library().hetmogp_chol_blocked_grid()} blocks a "
          f"launch [card: {smi}]")
    ok = True
    cases = [(q, m, stack(q, m)) for q, m in shapes]
    cases += [(4, 777, kuu(4, 777)), (2, 4096, kuu(2, 4096))]
    for q, m, K in cases:
        L64 = torch.linalg.cholesky(K.double())
        eye = torch.eye(m, dtype=torch.float64, device="cuda")
        iL64 = torch.linalg.solve_triangular(L64, eye.expand_as(L64),
                                             upper=False)
        before = ck.chol_blocked.launches
        L, iL = linalg.blocked_cholesky_inverse(K)
        L2, iL2 = linalg.blocked_cholesky_inverse(K)
        launches = ck.chol_blocked.launches - before
        Lp = linalg.cholesky(K)
        iLp = torch.linalg.solve_triangular(
            Lp, torch.eye(m, device="cuda").expand_as(Lp), upper=False)
        eL, eiL = normwise(L, L64), normwise(iL, iL64)
        ep, et = normwise(Lp, L64), normwise(iLp, iL64)
        zeros = not (torch.triu(L, 1).any() or torch.triu(iL, 1).any())
        same = torch.equal(L, L2) and torch.equal(iL, iL2)
        parts = True
        if q > 1:
            h = q // 2
            for part in (slice(0, h), slice(h, q)):
                a, b = linalg.blocked_cholesky_inverse(K[part])
                parts &= torch.equal(a, L[part]) and torch.equal(b, iL[part])
        static = K.clone()
        box = {}
        g = graphed(lambda: box.update(
            out=linalg.blocked_cholesky_inverse(static)))
        g.replay()
        torch.cuda.synchronize()
        replay = all(torch.equal(a, b) for a, b in zip(box["out"], (L, iL)))
        del g, box
        good = (eL <= 1.5 * ep and eiL <= 1.5 * et and zeros and same
                and parts and replay and launches == 2)
        ok &= good
        print(f"kernel 10 ({q}, {m}, {m}): normwise vs float64 L {eL:.3e} "
              f"({eL / ep:.2f}x potrf's {ep:.3e}), iL {eiL:.3e} "
              f"({eiL / et:.2f}x trsm's {et:.3e}); zeros above {zeros}; two "
              f"calls bitwise {same}; parts bitwise alone {parts}; graph "
              f"replay bitwise {replay}; launches {launches} "
              f"{'ok' if good else 'OFF'} [card: {smi}]")
        del L64, iL64, L, iL, L2, iL2, Lp, iLp
    K = stack(4, 1024).clone()
    K[1, 400, 400] = -1.0
    L, iL = linalg.blocked_cholesky_inverse(K)
    first = 400 // TILE * TILE
    rows, cols = torch.tril_indices(1024, 1024, device="cuda")
    right, below = cols >= first, rows >= first
    nan = (bool(torch.isfinite(L[[0, 2, 3]]).all())
           and bool(torch.isfinite(iL[[0, 2, 3]]).all())
           and bool(torch.isnan(L[1][rows[right], cols[right]]).all())
           and bool(torch.isfinite(L[1][rows[~right], cols[~right]]).all())
           and not bool(torch.triu(L[1], 1).any())
           and bool(torch.isnan(iL[1][rows[below], cols[below]]).all())
           and bool(torch.isfinite(iL[1, :first]).all())
           and not bool(torch.triu(iL[1, :first], 1).any()))
    ok &= nan
    print(f"kernel 10, a non-SPD Kuu (matrix 1, pivot 400): NaN from panel "
          f"{first // TILE} on in L's columns and iL's rows (on and below "
          f"the diagonal), the rest finite, zeros above {nan} "
          f"[card: {smi}]")
    return ok


def times(shapes, reps: int, smi: str) -> None:
    from hetmogp_tpu_torch.ops import linalg

    for q, m in shapes:
        K = stack(q, m)
        eye = torch.eye(m, device="cuda").expand_as(K)
        fns = {"pair": lambda: linalg.blocked_cholesky_inverse(K),
               "library": lambda: torch.linalg.solve_triangular(
                   torch.linalg.cholesky_ex(K)[0], eye, upper=False)}
        graphs = {k: graphed(f) for k, f in fns.items()}
        t = in_turns({**{k: g.replay for k, g in graphs.items()},
                      "empty": ck.empty_launch}, reps)
        bound = bound_ms(4 * q * (m * (m + 1) // 2 + 2 * m * m),
                         2 * q * m ** 3 / 3, F32_PEAK)
        print(f"times ({q}, {m}, {m}), graphed, device ms (median, min, max "
              f"of {2 * reps}): " + "; ".join(
                  f"{k} {v[0]:.4f} ({v[1]:.4f}, {v[2]:.4f})"
                  for k, v in t.items())
              + f"; bound {bound[0]:.4f} ms, {bound[1]} "
              f"({bound[0] / t['pair'][0] * 100:.2f}% of the pair) "
              f"[card: {smi}]")
        del graphs


class StampBuild:
    """``csrc/chol_blocked_kernel.cu`` alone with the probe stamps."""

    def __init__(self):
        self.name = "stamp build"
        out = _build.BUILD_DIR / "k10probe"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "chol_blocked.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DK10_STAMPS", "-o",
               str(lib), str(_build.CSRC / "chol_blocked_kernel.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.log = proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{self.log}")
        so = ctypes.CDLL(str(lib))
        self.entry = so.hetmogp_chol_blocked_f32
        self.entry.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                               + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                               + [ctypes.c_void_p])
        self.entry.restype = ctypes.c_int
        self.stamps = so.hetmogp_chol_blocked_stamps
        self.stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        self.stamps.restype = ctypes.c_int
        self.grid = so.hetmogp_chol_blocked_grid
        self.grid.restype = ctypes.c_int
        self.flags = so.hetmogp_chol_blocked_flags
        self.flags.argtypes = [ctypes.c_int] * 2
        self.flags.restype = ctypes.c_int

    def __call__(self, K):
        q, m = K.shape[0], K.shape[-1]
        nt = m // TILE
        L, iL = torch.empty_like(K), torch.empty_like(K)
        L64 = torch.empty_like(K, dtype=torch.float64)
        C = torch.empty((q, nt * (nt + 1) // 2, TILE, TILE),
                        dtype=torch.float64, device=K.device)
        flags = torch.zeros(self.flags(q, nt), dtype=torch.int32,
                            device=K.device)
        err = self.entry(K.data_ptr(), K.stride(0), K.stride(1),
                         L.data_ptr(), iL.data_ptr(), L64.data_ptr(),
                         C.data_ptr(),
                         flags.data_ptr(), q, nt,
                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: launch error {err}")
        return L, iL

    def read(self, tasks: int):
        buf = (ctypes.c_longlong * (tasks * PER_TASK))()
        if self.stamps(buf, tasks):
            raise RuntimeError("reading the stamps failed")
        rows = [list(buf[i * PER_TASK:(i + 1) * PER_TASK])
                for i in range(tasks)]
        return [dict(ticket=r[0], start=r[1], end=r[2], sm=r[3],
                     kind=KINDS[r[4]], b=(r[5] >> 32) & 0xff,
                     part=(r[5] >> 24) & 0xff, i=(r[5] >> 16) & 0xff,
                     k=(r[5] >> 8) & 0xff, j=r[5] & 0xff) for r in rows]


def union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def stamp_report(b: StampBuild, K, smi: str) -> None:
    q, m = K.shape[0], K.shape[-1]
    nt = m // TILE
    b(K)
    torch.cuda.synchronize()
    tasks = ck.chol_blocked_tasks(q, nt)
    st = b.read(tasks)
    t0 = min(s["ticket"] for s in st)
    t1 = max(s["end"] for s in st)
    span = (t1 - t0) / 1e3
    sms = {}
    for s in st:
        sms.setdefault(s["sm"], []).append((s["start"], s["end"]))
    busy = sum(union(v) for v in sms.values()) / (len(sms) * (t1 - t0))
    print(f"  {b.name} ({q}, {m}, {m}): {tasks} tasks on {len(sms)} SMs "
          f"({b.grid()} blocks), {span:.1f} us from the first ticket to the "
          f"last end; SMs busy {busy * 100:.1f}% of it [card: {smi}]")
    for kind in KINDS:
        d = [(s["end"] - s["start"]) / 1e3 for s in st if s["kind"] == kind]
        w = [(s["start"] - s["ticket"]) / 1e3 for s in st
             if s["kind"] == kind]
        if d:
            print(f"    {kind}: {len(d)} tasks, mean {statistics.mean(d):.1f} "
                  f"us (min {min(d):.1f}, max {max(d):.1f}); mean wait "
                  f"from ticket to start {statistics.mean(w):.1f} us")
    potrf = {s["k"]: s for s in st if s["kind"] == "POTRF" and s["b"] == 0}
    prev = t0
    parts = []
    for p in range(nt):
        s = potrf[p]
        parts.append(f"p{p}: +{(s['end'] - prev) / 1e3:.1f} (wait "
                     f"{(s['start'] - prev) / 1e3:.1f}, POTRF "
                     f"{(s['end'] - s['start']) / 1e3:.1f})")
        prev = s["end"]
    tail = (max(s["end"] for s in st if s["b"] == 0) - prev) / 1e3
    print("    critical path, matrix 0, us from the last POTRF's end: "
          + "; ".join(parts) + f"; after the last POTRF {tail:.1f}")
    # between POTRF(p)'s end and POTRF(p + 1)'s start, matrix 0: the
    # chain's TRSM(p + 1, p) parts, then UPD(p + 1, p + 1, p) parts, each
    # as (latest start, latest end) after POTRF(p)'s end
    steps = []
    for p in range(nt - 1):
        e0 = potrf[p]["end"]
        trsm = [s for s in st if s["b"] == 0 and s["kind"] == "TRSM"
                and (s["i"], s["k"]) == (p + 1, p)]
        upd = [s for s in st if s["b"] == 0 and s["kind"] == "UPD"
               and (s["i"], s["k"], s["j"]) == (p + 1, p + 1, p)]
        steps.append(
            f"p{p}: TRSM x{len(trsm)} start +"
            f"{(max(s['start'] for s in trsm) - e0) / 1e3:.1f} end +"
            f"{(max(s['end'] for s in trsm) - e0) / 1e3:.1f}, UPD "
            f"x{len(upd)} start +{(max(s['start'] for s in upd) - e0) / 1e3:.1f}"
            f" end +{(max(s['end'] for s in upd) - e0) / 1e3:.1f}, POTRF "
            f"start +{(potrf[p + 1]['start'] - e0) / 1e3:.1f}")
    print("    the chain, matrix 0, us after POTRF(p)'s end: "
          + "; ".join(steps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--shapes", default="4x1024,8x1024")
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    shapes = shapes_of(args.shapes)
    ck.load()
    ok = True
    if args.check:
        ok &= check(shapes, smi)
    if args.times:
        times(shapes, args.reps, smi)
    if args.stamps:
        b = StampBuild()
        for kernel, line in _build.ptxas_lines(b.log):
            if kernel.startswith("chol_blocked_kernel"):
                print(f"  {b.name}: ptxas {kernel}: {line} [card: {smi}]")
        for q, m in shapes:
            K = stack(q, m)
            stamp_report(b, K, smi)
            t = in_turns({b.name: lambda: b(K)}, args.reps)[b.name]
            print(f"  stamp build ({q}, {m}, {m}), eager, device ms: median "
                  f"{t[0]:.4f} (min {t[1]:.4f}, max {t[2]:.4f}) [card: {smi}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
