"""Spans on the card: what they cost off and on, and what they read.

    python3 -m hetmogp_tpu_torch.probes.spans [--phases smoke,cost,cross,ab]
        [--cells lmc6-train,fam10-train,lmc6-serve] [--parent DIR]
        [--calls 24] [--warm 10] [--seed N] [--names 12]

Each phase prints its lines, with the card's name and power limit:

* ``smoke``: the stamp kernel eagerly, the clocks' offset, and a small
  captured graph (a cuBLAS product, a fill, the RBF hand kernel between
  two marks, then ``pos += 1``): the node census at the marks, the ring
  untouched by the plain graph and written by its stamped clone.
* ``cost``: in one process, for each train cell (built by ``hmbench``
  from the seed, as its runs build it), device ms a step of whole calls
  of the cell's steps (CUDA events around each call), in turns: the
  trainer's calls with spans off (its plain graphs) and under
  ``profiling.spans()`` (on: the stamped clones); for
  ``lmc6-serve``, the host time of a request (to its synchronize), in
  blocks of the cell's requests with spans off and on.
* ``cross``: for each cell, one call (the cell's traced steps) or the
  cell's traced requests under torch.profiler with spans on: the stamps
  in the profiler's device timeline, in launch order, mark each span's
  interval there; by span, device time, busy and idle time a step or a
  request, and kernels by class a step beside the graphs' node counters
  (``step.library_kernels.train``'s check); the idle gaps by the span
  they fall in and the kernel that ended them; and the report's
  ``%globaltimer`` walls beside the profiler's.
* ``ab``: the off-cost against another checkout (``--parent``, e.g. the
  parent commit unpacked with ``git archive``): device ms a step of
  ``--calls`` calls of ``lmc6-train``, CUDA events around each call, in
  the order parent, change, change, parent, one process a turn.

A measurement script run by hand from a checkout with ``hmbench``: the
packaging leaves this directory out of an installed ``hetmogp_tpu_torch``.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 2121

# one turn of ``ab``, run from a checkout's root (cwd); prints one JSON line
AB_SIDE = """
import json, sys, time, torch
sys.path.insert(0, ".")
from hmbench import run as hrun
from hmbench.kinds import train as ktrain
spec = hrun.Spec("lmc6-train")
s = ktrain.build(spec.cfg, spec.mix, {seed}, "cuda")
t0 = time.perf_counter()
while time.perf_counter() - t0 < {warm}:
    ktrain.call(s)
    torch.cuda.synchronize()
ms = []
for _ in range({calls}):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    ktrain.call(s)
    b.record()
    b.synchronize()
    ms.append(a.elapsed_time(b) / s.K)
print("AB " + json.dumps(ms))
"""


def card() -> str:
    from hetmogp_tpu_torch import profiling
    return profiling.card()


def quartiles(xs) -> str:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return (f"median {q[1]:.5f} (quartiles {q[0]:.5f}-{q[2]:.5f}, "
            f"spread {(q[2] - q[0]) / q[1] * 100:.2f}%, n={len(xs)})")


# ---- smoke ------------------------------------------------------------------

def smoke(args, smi) -> None:
    from hetmogp_tpu_torch import profiling
    from hetmogp_tpu_torch.ops import cuda_kernels

    cuda_kernels.load()
    dev = torch.device("cuda")
    print(f"clock: {profiling._calibrate(dev)} [card: {smi}]")
    ring = torch.full((8,), -1, dtype=torch.int64, device=dev)
    stamp = cuda_kernels.stamper(ring)
    stamp(0)
    torch.cuda._sleep(1_000_000)
    stamp(1)
    got = ring.tolist()
    print(f"eager stamps: {got[:2]}, {(got[1] - got[0]) / 1e3:.1f} us apart "
          f"around a sleep of 1e6 cycles")
    a = torch.randn(256, 256, device=dev)
    X = torch.rand(512, 2, device=dev)
    Z = torch.rand(4, 64, 2, device=dev)
    ls, var = torch.full((4, 2), 0.3, device=dev), torch.ones(4, device=dev)
    pos = torch.zeros(1, dtype=torch.int64, device=dev)
    ring = torch.full((16,), -1, dtype=torch.int64, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        (a @ a).fill_(0.0)
        cuda_kernels.rbf_K_batched(X, Z, ls, var)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    marks, census = cuda_kernels.GraphMarks(), []
    with torch.cuda.graph(graph, stream=side):
        census.append(marks.mark(torch.cuda.current_stream()))
        (a @ a).fill_(0.0)
        cuda_kernels.rbf_K_batched(X, Z, ls, var)
        census.append(marks.mark(torch.cuda.current_stream()))
        pos.add_(1)
    graph.instantiate()
    stamped = cuda_kernels.StampedGraph(marks, graph, ring, pos, 4)
    print(f"census at the two marks: {census}")
    graph.replay()
    torch.cuda.synchronize()
    off = ring.tolist()
    pos.zero_()
    stamped.launch()
    torch.cuda.synchronize()
    print(f"the plain graph: ring {off[:2]}, pos {pos.item()}; the stamped "
          f"clone: ring {ring.tolist()[:2]} (row 0, before pos += 1)")
    print(f"clock samples: {cuda_kernels.clock_samples(4, dev)}")


# ---- building the cells -----------------------------------------------------

def train_cell(cell: str, seed: int):
    from hmbench import run as hrun
    from hmbench.kinds import train as ktrain

    spec = hrun.Spec(cell)
    return spec, ktrain.build(spec.cfg, spec.mix, seed, "cuda")


def warm(fn, seconds: float) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()


def call_ms(fn) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


# ---- cost -------------------------------------------------------------------

def cost(args, smi) -> None:
    from torch.profiler import ProfilerActivity, profile

    from hetmogp_tpu_torch import profiling
    from hetmogp_tpu_torch.ops import cuda_kernels
    from hmbench.kinds import train as ktrain

    cuda_kernels.load()
    torch.zeros(1, device="cuda")

    def span_us(n=2000):
        """Host us of one empty span, entry to exit, over n spans."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("empty"):
                pass
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    got = {"off": span_us()}
    with profiling.spans():
        got["spans()"] = span_us()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got["profiler"] = span_us()
    print(f"cost of an empty span, host us (entry and exit, two stamps): "
          f"{got} [card: {smi}]")

    for cell in [c for c in args.cells if c.endswith("train")]:
        spec, s = train_cell(cell, args.seed)

        def on():
            with profiling.spans():  # its set-up outside the events
                return call_ms(lambda: ktrain.call(s))

        sides = {"off": lambda: call_ms(lambda: ktrain.call(s)), "on": on}
        warm(lambda: [f() for f in sides.values()], args.warm)
        ms = {k: [] for k in sides}
        for i in range(args.calls):
            order = list(sides) if i % 2 == 0 else list(sides)[::-1]
            for k in order:
                ms[k].append(sides[k]() / s.K)
        for k, v in ms.items():
            print(f"cost {cell} {k}: device ms a step, calls of {s.K}: "
                  f"{quartiles(v)} [card: {smi}]")
        d = [(a - b) / b * 100 for a, b in zip(ms["on"], ms["off"])]
        print(f"cost {cell} on - off, paired: {quartiles(d)} (%)")
        print(f"cost {cell} raw: {json.dumps(ms)}")
        del s
        torch.cuda.empty_cache()
    if "lmc6-serve" in args.cells:
        serve_cost(args, smi)


def serve_cell(seed: int):
    from hmbench import run as hrun
    from hmbench.kinds import serve_closed

    spec = hrun.Spec("lmc6-serve")
    return spec, serve_closed.build(spec.cfg, spec.mix, seed, "cuda")


def serve_cost(args, smi) -> None:
    from hetmogp_tpu_torch import profiling
    from hmbench.kinds import serve_closed

    spec, s = serve_cell(args.seed)
    n = spec.mix["trace_requests"]

    def block(on: bool) -> list:
        reqs = [next(s.sched) for _ in range(n)]
        out = []
        ctx = profiling.spans() if on else profiling._NULL
        with ctx:
            for r in reqs:
                t0 = time.perf_counter()
                serve_closed.serve(s, r)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    warm(lambda: block(False), args.warm)
    ms = {"off": [], "on": []}
    for i in range(args.calls):
        for k in (("off", "on") if i % 2 == 0 else ("on", "off")):
            ms[k] += block(k == "on")
    for k, v in ms.items():
        print(f"cost lmc6-serve {k}: host ms a request (to its synchronize), "
              f"mean {statistics.mean(v):.4f}, {quartiles(v)} [card: {smi}]")


# ---- cross ------------------------------------------------------------------

def device_events(fn):
    """(name, start us, end us) of every device activity of ``fn()`` under
    torch.profiler, in time order, with spans on (the session's)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda]
    return sorted(ev, key=lambda e: e[1])


def stamp_order(rec) -> list:
    """(occurrence index, "start" or "end") of every stamp of the record,
    in launch order, with the occurrences as ``span_report`` lists them."""
    order = []
    for i, s in enumerate(rec.spans):
        for which, slot in (("start", s.start_slot), ("end", s.end_slot)):
            if slot is not None:
                order.append((slot, i, which))
    order = [(i, w) for _, i, w in sorted(order)]
    base = len(rec.spans)
    for run in rec.runs:
        for kind in run.kinds:
            plan = run.plans[kind]
            marks = sorted((b, k, w) for k, s in enumerate(plan)
                           for w, b in (("start", s.start), ("end", s.end))
                           if b is not None)
            order += [(base + k, w) for _, k, w in marks]
            base += len(plan)
    return order


def classify(name: str) -> str:
    from hmbench import trace

    if "span_stamp_kernel" in name:
        return "stamps"
    if name.startswith(("Memcpy", "Memset")):
        return "memory"
    return "hand" if trace.symbol_of(name) is not None else "library"


def timeline(events, rep, rec):
    """Each occurrence's [start, end] on the profiler's clock, from the
    stamps' device events in launch order; None if their count differs."""
    stamps = [e for e in events if "span_stamp_kernel" in e[0]]
    order = stamp_order(rec)
    if len(stamps) != len(order):
        return None, f"{len(stamps)} stamp records for {len(order)} stamps"
    at = [[None, None] for _ in rep["occurrences"]]
    for (i, which), e in zip(order, stamps):
        at[i][0 if which == "start" else 1] = e[1]
    return at, ""


def breakdown(events, rep, at, per: int, smi, what: str) -> None:
    """By span name: wall, busy and idle device time a ``per`` (steps or
    requests), self parts only, kernels by class; the idle gaps by the
    innermost span they fall in and the kernel that ended them."""
    import bisect

    occ = rep["occurrences"]
    kernels = [e for e in events if "span_stamp_kernel" not in e[0]]
    members = {}
    for i, o in enumerate(occ):
        if at[i][0] is not None and at[i][1] is not None:
            members.setdefault(o["group"], []).append(i)
    tops = sorted((at[i][0], at[i][1], o["group"]) for i, o in enumerate(occ)
                  if o["parent"] is None and at[i][0] is not None
                  and at[i][1] is not None)
    starts = [t[0] for t in tops]

    def innermost(t):
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t >= tops[k][1]:
            return None
        best = None
        for i in members[tops[k][2]]:
            s, e = at[i]
            if s <= t < e and (best is None or s >= at[best][0]):
                best = i
        return best

    rows = {}
    for i, o in enumerate(occ):
        s, e = at[i]
        if s is None or e is None:
            continue
        row = rows.setdefault(o["name"], {"wall": 0.0, "busy": 0.0,
                                          "hand": 0, "library": 0,
                                          "memory": 0, "n": 0})
        row["wall"] += e - s
        row["n"] += 1
    def where(t):
        i = innermost(t)
        return "between top-level spans" if i is None else occ[i]["name"]

    for name, s, e in kernels:
        i = innermost(s)
        if i is not None:
            row = rows[occ[i]["name"]]
            row["busy"] += e - s
            row[classify(name)] += 1
    # idle: every gap between device activities (stamps too), put in the
    # innermost span around its middle, with the activity that ended it
    idle, busy_end = {}, None
    for name, s, e in events:
        if busy_end is not None and s > busy_end:
            gap = idle.setdefault(where((s + busy_end) / 2),
                                  {"us": 0.0, "n": 0, "by": {}})
            gap["us"] += s - busy_end
            gap["n"] += 1
            short = name.split("(")[0][:60]
            gap["by"][short] = gap["by"].get(short, 0.0) + s - busy_end
        busy_end = e if busy_end is None else max(busy_end, e)
    print(f"cross {what}: by span, a {per} (device us; busy: kernels whose "
          f"start lies in the span and in none of its children) [card: {smi}]")
    n = {"step": rep["steps"]}.get(per, len(rep["groups"]))
    for k, r in rows.items():
        print(f"  {k}: x{r['n'] / n:.2f}, wall {r['wall'] / n:.2f}, busy self "
              f"{r['busy'] / n:.2f}, kernels self hand {r['hand'] / n:.1f} "
              f"library {r['library'] / n:.1f} memory {r['memory'] / n:.1f}")
    for k, g in sorted(idle.items(), key=lambda kv: -kv[1]["us"]):
        top = sorted(g["by"].items(), key=lambda kv: -kv[1])[:3]
        print(f"  idle in {k}: {g['us'] / n:.2f} us a {per} ({g['n']} gaps); "
              f"ended by " + ", ".join(f"{a} {b / n:.2f}" for a, b in top))


def cross(args, smi) -> None:
    from hetmogp_tpu_torch import profiling
    from hmbench.kinds import train as ktrain

    for cell in [c for c in args.cells if c.endswith("train")]:
        spec, s = train_cell(cell, args.seed)
        warm(lambda: ktrain.call(s), args.warm)
        steps = spec.mix["trace_steps"]
        for attempt in range(4):
            events = device_events(lambda: ktrain.call(s, steps))
            rep, rec = profiling.span_report(), profiling._record
            at, why = timeline(events, rep, rec)
            if at is not None:
                break
            print(f"cross {cell}: trace {attempt + 1}: {why}; again")
        else:
            continue
        counters = rep["counters"]
        got = {}
        for g in rep["groups"]:
            i = next(k for k, o in enumerate(rep["occurrences"])
                     if o["group"] == g["id"] and o["parent"] is None)
            s0, s1 = at[i]
            n = {"hand": 0, "library": 0, "memory": 0}
            for name, t, _ in events:
                if s0 <= t <= s1 and "span_stamp_kernel" not in name:
                    n[classify(name)] += 1
            for k, v in n.items():
                got.setdefault((g["kind"], k), []).append(v)
        for kind in ("ve", "vm"):
            g = next(g for g in rep["groups"] if g["kind"] == kind)
            i = next(k for k, o in enumerate(rep["occurrences"])
                     if o["group"] == g["id"] and o["parent"] is None)
            names = {}
            for name, t, _ in events:
                if at[i][0] <= t <= at[i][1] and classify(name) != "hand" \
                        and "span_stamp_kernel" not in name:
                    key = (classify(name), name[:90])
                    names[key] = names.get(key, 0) + 1
            top = sorted(names.items(), key=lambda kv: -kv[1])[:args.names]
            print(f"cross {cell} {kind} step {g['index']}: {len(names)} "
                  f"names; top: {top}")
        for (kind, k), v in sorted(got.items()):
            print(f"cross {cell} {kind} steps, {k} records a step in the "
                  f"trace: {sorted(set(v))} (the graph's counter: "
                  f"{counters[kind]['step'].get(k)})")
        cyc = spec.cfg["train"]["ve_steps_per_vm"]
        lib = (cyc * counters["ve"]["step"]["library"]
               + counters["vm"]["step"]["library"]) / (cyc + 1)
        print(f"cross {cell}: counters {json.dumps(counters)}; library "
              f"kernels a step over the cycle {lib:.1f}")
        for name, r in rep["spans"].items():
            print(f"cross {cell} report {name}: x{r['count']}, wall "
                  f"{r['wall_ms'] / rep['steps']:.4f} ms a step, self "
                  f"{r['self_ms'] / rep['steps']:.4f}")
        print(f"cross {cell} clock {rep['clock']}")
        breakdown(events, rep, at, "step", smi, cell)
        del s
        torch.cuda.empty_cache()
    if "lmc6-serve" in args.cells:
        from hmbench.kinds import serve_closed

        spec, s = serve_cell(args.seed)
        block = [next(s.sched) for _ in range(spec.mix["trace_requests"])]

        def requests():
            for r in block:
                serve_closed.serve(s, r)
                torch.cuda.synchronize()

        requests()
        for attempt in range(4):
            events = device_events(requests)
            rep, rec = profiling.span_report(), profiling._record
            at, why = timeline(events, rep, rec)
            if at is not None:
                break
            print(f"cross lmc6-serve: trace {attempt + 1}: {why}; again")
        else:
            return
        gaps = [g["us"] for g in rep["gaps"]]
        held = {}
        for g in rep["gaps"]:
            held.setdefault((g["to"], g["held_by"]), []).append(g["host_late_us"])
        print(f"cross lmc6-serve: request gaps (stamps) {quartiles(gaps)} us; "
              f"by (to, held_by): { {k: len(v) for k, v in held.items()} }; "
              f"host late us {quartiles([x for v in held.values() for x in v])}")
        print(f"cross lmc6-serve clock {rep['clock']}")
        breakdown(events, rep, at, "request", smi, "lmc6-serve")


# ---- ab ---------------------------------------------------------------------

def ab(args, smi) -> None:
    sides = {"parent": args.parent.resolve(), "change": HERE}
    code = AB_SIDE.format(seed=args.seed, warm=args.warm, calls=args.calls)
    got = {"parent": [], "change": []}
    for turn, side in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run([sys.executable, "-c", code], cwd=sides[side],
                             capture_output=True, text=True)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode != 0 or not line:
            print(f"ab turn {turn} {side}: exit {out.returncode}\n"
                  f"{out.stderr[-3000:]}")
            continue
        ms = json.loads(line[-1][3:])
        got[side].append(statistics.median(ms))
        print(f"ab turn {turn} {side}: device ms a step of lmc6-train calls: "
              f"{quartiles(ms)} [card: {smi}]")
        print(f"ab turn {turn} {side} raw: {json.dumps(ms)}")
    if got["parent"] and got["change"]:
        p, c = statistics.mean(got["parent"]), statistics.mean(got["change"])
        print(f"ab: turn medians parent {got['parent']}, change "
              f"{got['change']}; change - parent {(c - p) / p * 100:+.3f}%")


PHASES = {"smoke": smoke, "cost": cost, "cross": cross, "ab": ab}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="smoke,cost,cross")
    ap.add_argument("--cells", default="lmc6-train,fam10-train,lmc6-serve")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--warm", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--names", type=int, default=12)
    args = ap.parse_args()
    args.cells = args.cells.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    smi = card()
    print(f"card: {smi}")
    failed = 0
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        try:
            PHASES[name](args, smi)
            print(f"PHASE {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception as e:  # each phase on its own: report, go on
            import traceback
            traceback.print_exc()
            print(f"PHASE {name}: FAILED {type(e).__name__}: {e}")
            failed += 1
        sys.stdout.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
