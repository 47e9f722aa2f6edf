"""Traffic kind "serve_closed": batch scoring through the program's
``make_serving_predictive``, one served callable a task built in set-up,
one caller in a closed loop.

Requests come in blocks that hold every (task, size) pair of the mix once,
in an order drawn from the seed, so every seed sends the same work; a
request's rows are a slice, at an offset drawn from the seed, of a pool of
rows uniform in [0,1)^Dx made in set-up.  Set-up serves one block to warm
every shape.  Each request is timed from the call until its moments are on
the device and synchronized.  ``serve_rows_per_s`` is every row served in
the window over the window's wall time, ``serve_p95_ms`` the 95th
percentile of every request's latency.  Requests are kept for the check
at random (one in ``keep_one_in``, drawn from the seed), and the first
request of the largest size of each task always.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from hmbench import check, inputs, port, trace
from hmbench.kinds import Result
from hmbench.reference import svgp
from hmbench.roofline import launchers


class Schedule:
    """The seeded request stream: (task, rows, offset, kept)."""

    def __init__(self, seed: int, tasks: int, sizes, pool: int, keep_one_in: int):
        self.rng = np.random.default_rng(seed)
        self.pairs = [(t, s) for s in sizes for t in range(tasks)]
        self.pool, self.keep_one_in, self.largest = pool, keep_one_in, max(sizes)
        self.block = []
        self.seen_largest = set()

    def __iter__(self):
        return self

    def __next__(self):
        if not self.block:
            self.block = [self.pairs[i] for i in self.rng.permutation(len(self.pairs))]
        task, rows = self.block.pop()
        offset = int(self.rng.integers(0, self.pool - rows + 1))
        kept = bool(self.rng.integers(0, self.keep_one_in) == 0)
        if rows == self.largest and task not in self.seen_largest:
            self.seen_largest.add(task)
            kept = True
        return task, rows, offset, kept


def build(cfg: dict, mix: dict, seed: int, dev, log=lambda what: None):
    """The served callables, the request pool and the schedule from the
    seed, every shape warmed."""
    port.load_kernels(dev)
    log("kernel library loaded")
    gen = inputs.generator(seed, dev)
    s = SimpleNamespace(cfg=cfg, p0=inputs.init_params(cfg, gen, dev, serving=True))
    config = port.model_config(cfg, cfg["serve"]["ve_fwd_precision"])
    s.fns = port.serving_fns(port.params(s.p0), config)
    log("served callables built")
    s.pool = torch.rand((mix["pool_rows"], cfg["input_dim"]), generator=gen,
                        dtype=torch.float32, device=dev)
    for rows in mix["sizes"]:
        for fn in s.fns:
            fn(s.pool[:rows])
    s.sched = Schedule(seed, len(s.fns), mix["sizes"], mix["pool_rows"], mix["keep_one_in"])
    return s


def serve(s, request):
    task, rows, off, _ = request
    X = s.pool[off:off + rows]
    return (task, X, *s.fns[task](X))


def run(ctx) -> Result:
    s = build(ctx.cfg, ctx.mix, ctx.seed, ctx.device, ctx.log)
    ctx.sync()
    setup_s = ctx.elapsed()
    ctx.log("set-up done")

    lat, rows_done, kept = [], 0, []
    counts0 = ctx.launch_counts()
    t_start = time.perf_counter()
    while True:
        request = next(s.sched)
        r0 = time.perf_counter()
        out = serve(s, request)
        ctx.sync()
        r1 = time.perf_counter()
        lat.append(r1 - r0)
        rows_done += request[1]
        if request[3]:
            kept.append(out)
        if r1 - t_start >= ctx.seconds:
            break
    window_s = r1 - t_start
    counts1 = ctx.launch_counts()
    res = Result(attempted=len(lat), setup_s=setup_s,
                 e2e={"serve_rows_per_s": rows_done / window_s,
                      "serve_p95_ms": float(np.percentile(np.array(lat) * 1e3, 95))},
                 memory_peak_bytes=ctx.memory_peak(),
                 failed=sum(not (bool(torch.isfinite(m).all()) and bool(torch.isfinite(v).all()))
                            for _, _, m, v in kept))

    ctx.log("window done")
    if ctx.trace:
        block = [next(s.sched) for _ in range(ctx.mix["trace_requests"])]
        last = {}

        def traced():
            last["before"] = ctx.launch_counts()
            with port.record_launches() as last["recorded"]:
                for request in block:
                    serve(s, request)
                    ctx.sync()

        def expected():
            now = ctx.launch_counts()
            return trace.expected_symbols({k: now[k] - last["before"][k] for k in now})

        res.trace = ctx.take(traced, expected)
        ctx.log("trace done")
        res.layer.update(
            kind="serve", trace=res.trace,
            launches=launchers.table(last.get("recorded", [])),
            launches_per_request=((sum(counts1.values()) - sum(counts0.values())) / len(lat)
                                  if counts0 else None))
        ctx.read_layers(res)
        res.layer.clear()
    s.fns = None
    ctx.free()
    ctx.log("program freed; the reference")
    ref = svgp.Reference(ctx.cfg, ctx.device, "float64")
    res.checks = check.beside(check.serve_numbers(ref, s.p0, kept), ctx.limits)
    return res
