"""Tracing, profiling and numerical-debug hooks.

Counterpart of ``hetmogp_tpu/profiling.py``:

* ``trace(logdir)``: profile the block with ``torch.profiler`` (the CPU,
  and the card where there is one) and write a Chrome trace into
  ``logdir``, and the block's spans beside it;
* spans: ``annotate(name)`` marks a layer of the program's work (the
  trainer's ``step``, ``elbo.projections``, ``elbo.likelihood``,
  ``backward.likelihood``, ``backward.projections``, ``refresh``; a
  natural-gradient VE step's ``natgrad.moments``, ``natgrad.likelihood``,
  ``natgrad.contractions``, ``natgrad.retraction`` and ``natgrad.factor``;
  the server's ``serve.request``, ``predict.moments``,
  ``predict.likelihood``).
  Spans are on while a ``torch.profiler`` session records (where they are
  also ``record_function`` ranges) or inside ``spans()``, which records
  them without the profiler; off, ``annotate`` checks one flag.  On the
  card each span's entry and exit are stamped with the device's clock by
  a one-thread kernel, also in the trainer's graphed steps: a call made
  while spans are on replays stamped clones of its CUDA graphs, any other
  call the plain graphs.
  ``span_report()`` gives each span's device time and self time, the
  device's idle gaps between steps or requests with the host span that
  held them, and ``graph_counters()``, the kernel nodes each span adds to
  a captured graph, by class; ``count(name, n)`` adds to a program
  counter of the innermost open span (``likelihood.table_tasks`` and
  ``likelihood.engine_tasks``: the tasks of a likelihood term on kernel
  6's task table and on their own engines; ``natgrad.attempts`` and
  ``natgrad.factorizations``: a natural-gradient step's attempts and its
  factorization calls, the spans ``natgrad.factor``, one of which factors
  both attempts' A), counted where the Python runs, never in a replayed
  graph;
* ``debug_nans(True)``: autograd's anomaly mode, which raises at the
  backward op that produced a NaN and names its forward;
* ``assert_finite(params, name)``: a host-side check of a params (or any
  state) dataclass that names the offending leaf;

and, for the measurements on an H100 (``chip_smoke.py``, the probes):

* ``card()``: the card's name and power limit, as ``nvidia-smi`` gives
  them;
* ``device_times_ms(fn)``: the device time of each of some calls, by CUDA
  events behind a device sleep;
* ``sampled_clocks(fn)``: ``clocks.sm`` and the power draw that
  ``nvidia-smi`` samples while ``fn`` runs back to back;
* ``bound_ms(nbytes, ops, peak)``: the least time the card could take,
  from the data sheet's peaks (``HBM_BYTES_PER_S``, ``F32_PEAK``,
  ``BF16_PEAK``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import re
import statistics
import subprocess
import threading
import time
from pathlib import Path
from typing import Any

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything in the block; the trace goes to
    ``{logdir}/trace_<time>.json`` (Chrome's trace format, which
    TensorBoard's and Perfetto's viewers read) and the block's spans
    (``span_report``) to ``{logdir}/spans_<time>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    stamp = time.time_ns()
    prof.export_chrome_trace(str(out / f"trace_{stamp}.json"))
    (out / f"spans_{stamp}.json").write_text(json.dumps(span_report()))


# ---- spans ------------------------------------------------------------------
#
# A span is a named part of the program's work: its parent, the group it
# belongs to (one step, or one request), the host's clock at its entry and
# exit (time.perf_counter_ns) and, on the card, the device's: a stamp kernel
# (csrc/span_stamp_kernel.cu, one thread) writes %globaltimer into a slot of
# a ring in device memory at each boundary, in stream order with the span's
# work.  Spans are on while a torch.profiler session records (torch's own
# start and stop hooks are wrapped below) or inside ``spans()``; starting
# either clears the process-wide record.  Otherwise ``annotate`` checks one
# flag and returns a shared no-op context.
#
# A captured CUDA graph runs its Python once, at capture: there a span
# records the graph's structure instead (``_Capture``) and marks its
# boundaries, where the node census gives the counters and where the
# trainer's stamped clone of the graph puts its stamps, which read the
# trainer's device step index to find their row of the trainer's ring.  The
# trainer replays the clones only while spans are on, so an untraced replay
# launches what it launched before.

#: slots of a captured step's row in its trainer's ring: two a span
STAMPS_PER_STEP = 32
#: slots of the eager spans' ring; older stamps are overwritten
EAGER_SLOTS = 1 << 16
#: samples of the two clocks that fix their offset (~0.2 ms each)
CLOCK_SAMPLES = 32

_NULL = contextlib.nullcontext()
# what ``annotate`` hands its spans to: None while spans are off and no
# trainer captures its graphs, the one flag the off path checks
_active = None
_depth = 0  # open sessions: torch.profiler sessions and spans() blocks
_record = None  # the current (or last) session's _Record
_capture = None  # the _Capture of a trainer's graphs while it captures
_counters: dict = {}  # {graph kind: {span: counts}} of the latest capture


def _refresh() -> None:
    global _active
    _active = _capture if _capture is not None else (
        _record if _depth else None)


def annotate(name: str):
    """A span, for traces and ``span_report``: ``with annotate('step'):``.
    Nests; spans off, it is a shared no-op context."""
    rec = _active
    return _NULL if rec is None else _Span(rec, name)


@contextlib.contextmanager
def spans():
    """Record spans without the profiler's cost, for ``span_report``: an
    operator's layer times from a production trainer (see README.md,
    "Tracing")."""
    _start_session()
    try:
        yield
    finally:
        _stop_session()


def split_backward(moments: list) -> list:
    """Mark the tensors of ``moments`` (a list of tuples of tensors) whose
    gradients end the first span of the next ``backward``; returns the
    moments to use from here on.  Spans off, they are ``moments`` itself;
    on, each tensor that requires grad goes through a view, a node made
    after every node of the moments' own, which autograd, taking the nodes
    it may run in the reverse order of their making, runs as soon as the
    gradient is complete: its hook ends the span there."""
    rec = _active
    if rec is None:
        return moments
    out = [tuple(t.view_as(t) if t.requires_grad else t for t in m)
           for m in moments]
    rec.pending = [t for m in out for t in m if t.requires_grad]
    return out


def backward(first: str, rest: str):
    """Spans of a backward pass, around the call that runs it: ``first``
    from its start until the gradients of the tensors ``split_backward``
    marked are complete (a gradient hook on each ends it), then ``rest``
    to its end; ``rest`` alone where nothing was marked."""
    rec = _active
    return _NULL if rec is None else rec.backward(first, rest)


def trainer_call():
    """A trainer's call: spans on, the context gives a ``_Call`` that
    numbers the call's steps (their groups' ``call`` and ``index``) and
    records its graph replays; spans off, None."""
    rec = _record if (_depth and _capture is None) else None
    return _NULL if rec is None else _Call(rec)


@contextlib.contextmanager
def capturing():
    """A trainer's capture of its graphs: spans record each graph's
    structure and mark its boundaries (``_Capture``); outside a capture
    (the warm-up) they record nothing.  The counters of each graph kind
    captured replace the process-wide ones."""
    global _capture
    cap = _Capture()
    _capture = cap
    _refresh()
    try:
        yield cap
    finally:
        _capture = None
        _refresh()
    _counters.update({kind: _tally(plan) for kind, plan in cap.plans.items()})


def count(name: str, n: int) -> None:
    """Add ``n`` to the program counter ``name`` of the innermost open
    span: at a graph's capture (``graph_counters()``, by graph kind) or in
    an eager span (``span_report()``, by span name).  Nothing is added to a
    replayed graph; spans off, or outside a span, nothing is counted."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


def graph_counters() -> dict:
    """{graph kind: {span: counts}} of the latest capture of each kind: the
    kernel nodes each span added to its graph by class (``hand``: the
    port's hand kernels; ``stamps``, none in a replayed graph: its stamped
    clone adds two a span; ``library``; ``memory``: memset and memcpy
    nodes; ``other``), ``launches``, the launch counters' increments
    ({launcher: launches}, which agree with the trainer's
    ``capture_launches``) and ``counts``, the program counters of
    ``count`` ({name: n})."""
    return {k: {n: dict(c, launches=dict(c["launches"]),
                        counts=dict(c["counts"])) for n, c in v.items()}
            for k, v in _counters.items()}


class _Span:
    __slots__ = ("owner", "name", "token")

    def __init__(self, owner, name: str):
        self.owner, self.name, self.token = owner, name, None

    def __enter__(self):
        self.token = self.owner.begin(self.name)
        return self

    def __exit__(self, *exc):
        self.owner.end(self.token)
        return False


class _Spans:
    """What the two recorders share: ``begin``/``end`` and the backward's
    split."""

    pending = None  # the tensors split_backward marked

    def count(self, name: str, n: int) -> None:
        span = self.stack[-1] if self.stack else None
        if span is not None:
            span.counts[name] = span.counts.get(name, 0) + n

    @contextlib.contextmanager
    def backward(self, first: str, rest: str):
        marks, self.pending = self.pending or [], None
        state = {"open": self.begin(first if marks else rest, False),
                 "left": len(marks)}
        lock = threading.Lock()

        def arrived(_grad):
            with lock:
                state["left"] -= 1
                if state["left"] == 0:
                    self.end(state["open"])
                    state["open"] = self.begin(rest, False)

        handles = [t.register_hook(arrived) for t in marks]
        try:
            yield
        finally:
            for h in handles:
                h.remove()
            if state["left"] > 0:  # a marked tensor got no gradient
                self.end(state["open"])
                state["open"] = self.begin(rest, False)
            self.end(state["open"])


class _Occurrence:
    """An eager span as it was recorded."""

    __slots__ = ("name", "parent", "group", "host_start", "host_end",
                 "start_slot", "end_slot", "range", "counts")

    def __init__(self, name, parent, group):
        self.name, self.parent, self.group = name, parent, group
        self.host_start = self.host_end = None
        self.start_slot = self.end_slot = self.range = None
        self.counts = {}


class _Record(_Spans):
    """One session's spans: the eager ones, with their stamps in a device
    ring (``EAGER_SLOTS``), the trainers' calls that replayed graphs, the
    groups and the clocks' offset."""

    def __init__(self):
        self.spans, self.stack, self.groups, self.runs = [], [], [], []
        self.calls = 0
        self.call = None  # [call number, next step index] of a trainer call
        self.ring, self.slots, self.clock = None, 0, None
        self.stamp = None  # cuda_kernels.stamper of the ring
        self.closed, self.report = False, None

    def _device_ready(self) -> bool:
        """Whether stamps can be written: CUDA in use and the kernel library
        loaded (nothing is built for a span).  The first time, allocate the
        ring and fix the clocks' offset."""
        if self.stamp is not None:
            return True
        if not torch.cuda.is_initialized():
            return False
        from hetmogp_tpu_torch.ops import cuda_kernels

        if not cuda_kernels.loaded():
            return False
        device = torch.device("cuda", torch.cuda.current_device())
        self.ring = torch.full((EAGER_SLOTS,), -1, dtype=torch.int64,
                               device=device)
        self.clock = _calibrate(device)
        self.stamp = cuda_kernels.stamper(self.ring)
        return True

    def _group(self, name: str) -> int:
        g = {"id": len(self.groups), "name": name, "call": None,
             "index": None, "kind": None}
        if self.call is not None:
            g["call"], g["index"] = self.call
            self.call[1] += 1
        self.groups.append(g)
        return g["id"]

    def _stamp(self, ready: bool):
        if not ready:
            return None
        slot, self.slots = self.slots, self.slots + 1
        self.stamp(slot % EAGER_SLOTS)
        return slot

    def begin(self, name: str, host_range: bool = True):
        ready = self._device_ready()
        if ready and torch._C._cuda_isCurrentStreamCapturing():
            return None  # another's graph: its replays would repeat a stamp
        parent = self.stack[-1] if self.stack else None
        span = _Occurrence(name, parent, self._group(name) if parent is None
                           else parent.group)
        if host_range and torch.autograd.profiler._is_profiler_enabled:
            # a function-scope range: the profiler gives a user annotation
            # (record_function's) a twin on the device's timeline, which
            # would read as device activity; this one stays on the host's
            span.range = torch._C._profiler._RecordFunctionFast(name)
            span.range.__enter__()
        span.host_start = time.perf_counter_ns()
        span.start_slot = self._stamp(ready)
        self.spans.append(span)
        self.stack.append(span)
        return span

    def end(self, span) -> None:
        if span is None:
            return
        span.end_slot = self._stamp(self.stamp is not None)
        span.host_end = time.perf_counter_ns()
        if span.range is not None:
            span.range.__exit__(None, None, None)
            span.range = None
        self.stack.remove(span)


class _PlanSpan:
    """A span of a captured graph: its slots in the step's row, and the
    graph's node census and the launch counters at its boundaries."""

    __slots__ = ("name", "parent", "start", "end", "at", "nodes", "launches",
                 "counts")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.start = self.end = self.at = None
        self.nodes, self.launches = None, None  # set at the span's exit
        self.counts = {}


class _Capture(_Spans):
    """The spans of a trainer's graphs while they are captured: one plan
    (a list of ``_PlanSpan``) and one ``cuda_kernels.GraphMarks`` a graph
    kind.  Each boundary is marked, not stamped: the trainer adds the
    stamps to a clone of the captured graph (``cuda_kernels.StampedGraph``),
    so the graph it replays with spans off holds none."""

    def __init__(self):
        self.plans, self.marks, self.stack = {}, {}, []
        self.kind = None

    def start(self, kind: str) -> None:
        """The next capture is of the graph of ``kind``."""
        from hetmogp_tpu_torch.ops import cuda_kernels

        self.kind, self.stack = kind, []
        self.plans[kind], self.marks[kind] = [], cuda_kernels.GraphMarks()

    def _mark(self):
        """(boundary index, (census, launch counts)) at a boundary."""
        from hetmogp_tpu_torch.ops import cuda_kernels

        marks = self.marks[self.kind]
        census = marks.mark(torch.cuda.current_stream())
        return marks.count - 1, (census, cuda_kernels.launch_counts())

    def begin(self, name: str, host_range: bool = True):
        if self.kind is None or not torch.cuda.is_current_stream_capturing():
            return None  # the warm-up
        plan = self.plans[self.kind]
        span = _PlanSpan(name, plan.index(self.stack[-1])
                         if self.stack else None)
        span.start, span.at = self._mark()
        plan.append(span)
        self.stack.append(span)
        return span

    def end(self, span) -> None:
        if span is None:
            return
        span.end, (nodes, launches) = self._mark()
        nodes0, launches0 = span.at
        span.nodes = {k: nodes[k] - nodes0[k] for k in nodes}
        span.launches = {k: launches[k] - launches0[k] for k in launches
                         if launches[k] != launches0[k]}
        self.stack.remove(span)


def _tally(plan) -> dict:
    out = {}
    for s in plan:
        if s.nodes is None:
            continue
        c = out.setdefault(s.name, {"launches": {}, "counts": {}})
        for k, v in s.nodes.items():
            c[k] = c.get(k, 0) + v
        for part in ("launches", "counts"):
            for k, v in getattr(s, part).items():
                c[part][k] = c[part].get(k, 0) + v
    return out


class _Run:
    """A trainer call's replays while spans are on: the kinds, the host's
    clock at each launch, the ring's rows after each block of steps."""

    def __init__(self, call: int, plans: dict, ring: torch.Tensor):
        self.call, self.plans, self.ring = call, plans, ring
        self.kinds, self.launched, self.rows = [], [], []

    def launch(self, kind: str) -> None:
        self.kinds.append(kind)
        self.launched.append(time.perf_counter_ns())

    def block(self, steps: int) -> None:
        """A block of ``steps`` replays is enqueued: keep its rows (a copy
        on the device; nothing is read back)."""
        self.rows.append(self.ring[:steps * STAMPS_PER_STEP].clone())


class _Call:
    def __init__(self, rec: _Record):
        self.rec = rec

    def __enter__(self):
        self.rec.calls += 1
        self.number = self.rec.calls
        self.rec.call = [self.number, 0]
        return self

    def __exit__(self, *exc):
        self.rec.call = None
        return False

    def replays(self, plans: dict, ring: torch.Tensor) -> _Run:
        run = _Run(self.number, plans, ring)
        self.rec.runs.append(run)
        return run


def _start_session() -> None:
    global _record, _depth
    _record = _Record()
    _depth += 1
    _refresh()
    _record._device_ready()  # the ring and the clocks, ahead of the work


def _stop_session() -> None:
    global _depth
    _depth = max(0, _depth - 1)
    if _depth == 0 and _record is not None:
        _record.closed = True
    _refresh()


def _hook_profiler() -> None:
    """Wrap torch's own hooks at a profiler session's start and stop, so
    that a session records spans; idempotent."""
    ap = torch.autograd.profiler
    start = getattr(ap, "_run_on_profiler_start", None)
    stop = getattr(ap, "_run_on_profiler_stop", None)
    if start is None or stop is None or getattr(start, "spans", False):
        return

    def on_start():
        start()
        _start_session()

    def on_stop():
        _stop_session()
        stop()

    on_start.spans = on_stop.spans = True
    ap._run_on_profiler_start, ap._run_on_profiler_stop = on_start, on_stop


_hook_profiler()


def _calibrate(device) -> dict:
    """The offset of the host's clock (``time.perf_counter_ns``) from the
    device's ``%globaltimer``, host = device + offset, from CLOCK_SAMPLES
    samples (``cuda_kernels.clock_samples``: a device stamp between two
    host readings, a PCIe round trip apart).  Each bounds the offset from
    both sides; the offset is the middle of the tightest bounds, its
    uncertainty half their width.  The device's timer ticks in steps of
    ``resolution_ns``, which widen each bound by one step."""
    from hetmogp_tpu_torch.ops import cuda_kernels

    rows = cuda_kernels.clock_samples(CLOCK_SAMPLES, device)
    g = [x for _, x, _ in rows]
    step = next((r for r in (1000, 32) if all(x % r == 0 for x in g)), 1)
    lo = max(t0 - x - step for t0, x, _ in rows)
    hi = min(t1 - x for _, x, t1 in rows)
    return {"offset_ns": (lo + hi) // 2, "uncertainty_ns": (hi - lo) / 2,
            "resolution_ns": step, "samples": len(rows),
            "consistent": lo <= hi}


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_report() -> dict:
    """The spans of the current or last session ({} where it recorded
    none).  Reads the stamps back (a synchronize): call it after the
    work, never inside it.

    ``source``: "device" where stamps were written (every time below is
    then the device's), else "host".  ``steps``: the groups named
    ``step``.  ``groups``: one a step (``call``, ``index`` in the call,
    the graph ``kind`` of a replayed step) or a request.  ``spans``: by
    name, ``count``, ``timed`` (with both stamps), ``wall_ms`` and
    ``self_ms`` (wall minus the part of it its children cover), summed
    and per occurrence (``_mean``), and ``counts``, the program counters of
    its occurrences summed (a replayed step's: its graph's, as captured).  ``gaps``: the device's idle time
    between consecutive top-level spans (``us``), each put down (``to``)
    to the host span that was open when the host launched the work that
    ended it, "caller" where none was; ``host_late_us`` is how long after
    the device went idle the host launched that work (through the
    clocks' offset: positive, the host held the device; ``held_by``
    "host" where that exceeds the offset's uncertainty, else "device").
    ``clock``: the offset, its uncertainty and its drift by the report's
    time.  ``counters``: ``graph_counters()``.  ``occurrences``: every
    span, its ``parent`` an index into this list.
    """
    rec = _record
    if rec is None or not (rec.spans or rec.runs):
        return {}
    if rec.report is not None:
        return rec.report
    occ, groups, launched = _occurrences(rec)
    device = any(o["start_ns"] is not None for o in occ)
    key = ("start_ns", "end_ns") if device else ("host_start_ns",
                                                 "host_end_ns")
    children = {}
    for i, o in enumerate(occ):
        if o["parent"] is not None:
            children.setdefault(o["parent"], []).append(i)
    summary = {}
    for i, o in enumerate(occ):
        row = summary.setdefault(o["name"], {"count": 0, "timed": 0,
                                             "wall_ms": 0.0, "self_ms": 0.0,
                                             "counts": {}})
        row["count"] += 1
        for k, v in o["counts"].items():
            row["counts"][k] = row["counts"].get(k, 0) + v
        t0, t1 = o[key[0]], o[key[1]]
        if t0 is None or t1 is None:
            continue
        inner = [(max(t0, occ[c][key[0]]), min(t1, occ[c][key[1]]))
                 for c in children.get(i, ())
                 if occ[c][key[0]] is not None and occ[c][key[1]] is not None]
        inner = [(s, e) for s, e in inner if e > s]
        row["timed"] += 1
        row["wall_ms"] += (t1 - t0) * 1e-6
        row["self_ms"] += (t1 - t0 - _union_ns(inner)) * 1e-6
    for row in summary.values():
        for k in ("wall_ms", "self_ms"):
            row[k + "_mean"] = row[k] / row["timed"] if row["timed"] else None
    clock = dict(rec.clock) if rec.clock else None
    if clock is not None:
        later = _calibrate(rec.ring.device)
        clock["drift_ns"] = later["offset_ns"] - clock["offset_ns"]
    out = {"source": "device" if device else "host", "clock": clock,
           "steps": sum(g["name"] == "step" for g in groups),
           "groups": groups, "spans": summary,
           "gaps": _gaps(occ, launched, clock) if device else [],
           "counters": graph_counters(), "occurrences": occ}
    if rec.closed:
        rec.report = out
    return out


def _occurrences(rec: _Record):
    """(occurrences, groups, host launch time of each top-level
    occurrence's first work) of a record."""
    ring = rec.ring.tolist() if rec.ring is not None else None
    oldest = rec.slots - EAGER_SLOTS

    def stamp(slot):
        if ring is None or slot is None or slot < oldest:
            return None
        v = ring[slot % EAGER_SLOTS]
        return v if v >= 0 else None

    index = {id(s): i for i, s in enumerate(rec.spans)}
    occ = [{"name": s.name, "group": s.group,
            "parent": None if s.parent is None else index[id(s.parent)],
            "start_ns": stamp(s.start_slot), "end_ns": stamp(s.end_slot),
            "host_start_ns": s.host_start, "host_end_ns": s.host_end,
            "counts": dict(s.counts)}
           for s in rec.spans]
    launched = {i: o["host_start_ns"] for i, o in enumerate(occ)
                if o["parent"] is None}
    groups = [dict(g) for g in rec.groups]
    for run in rec.runs:
        rows = torch.cat(run.rows).tolist() if run.rows else []
        for j, kind in enumerate(run.kinds):
            row = rows[j * STAMPS_PER_STEP:(j + 1) * STAMPS_PER_STEP]
            g = len(groups)
            groups.append({"id": g, "name": "step", "call": run.call,
                           "index": j, "kind": kind})
            base = len(occ)
            for s in run.plans.get(kind, ()):
                got = [None if k is None or k >= len(row) or row[k] < 0
                       else row[k] for k in (s.start, s.end)]
                occ.append({"name": s.name, "group": g,
                            "parent": None if s.parent is None
                            else base + s.parent,
                            "start_ns": got[0], "end_ns": got[1],
                            "host_start_ns": None, "host_end_ns": None,
                            "counts": dict(s.counts)})
                if s.parent is None:
                    launched[len(occ) - 1] = run.launched[j]
    return occ, groups, launched


def _gaps(occ, launched, clock) -> list:
    top = sorted((i for i, o in enumerate(occ) if o["parent"] is None
                  and o["start_ns"] is not None and o["end_ns"] is not None),
                 key=lambda i: occ[i]["start_ns"])
    hosts = [(o["host_start_ns"], o["host_end_ns"], i) for i, o in
             enumerate(occ) if o["host_start_ns"] is not None
             and o["host_end_ns"] is not None]
    out = []
    for a, b in zip(top, top[1:]):
        A, B = occ[a], occ[b]
        gap = B["start_ns"] - A["end_ns"]
        if gap < 0:
            continue
        h = launched.get(b)
        # the innermost host span open at the launch, B's group aside
        open_ = [(s, i) for s, e, i in hosts if h is not None and s <= h < e
                 and occ[i]["group"] != B["group"]]
        late = None
        if clock is not None and h is not None:
            late = (h - (A["end_ns"] + clock["offset_ns"])) * 1e-3
        out.append({"after": A["group"], "before": B["group"], "us": gap * 1e-3,
                    "to": occ[max(open_)[1]]["name"] if open_ else "caller",
                    "host_late_us": late,
                    "held_by": None if late is None else (
                        "host" if late * 1e3 > clock["uncertainty_ns"]
                        else "device")})
    return out


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off: a backward op that
    returns NaN then raises, naming the forward op that made it."""
    torch.autograd.set_detect_anomaly(enable)


def _named_tensors(tree: Any, path: str):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, part in tree.items():
            yield from _named_tensors(part, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, part in enumerate(tree):
            yield from _named_tensors(part, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _named_tensors(getattr(tree, f.name),
                                      f"{path}.{f.name}")


def assert_finite(tree: Any, name: str = "params") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (a
    params or train-state dataclass, a dict, a tuple, a tensor) that holds a
    non-finite value.  Reads the leaves on the host."""
    for path, t in _named_tensors(tree, name):
        bad = ~torch.isfinite(t.detach())
        n_bad = int(bad.sum())
        if n_bad:
            raise FloatingPointError(
                f"{path}: {n_bad}/{t.numel()} non-finite values "
                f"(dtype={t.dtype}, shape={tuple(t.shape)})")


# ---- device measurement ----------------------------------------------------

# H100 SXM peaks (NVIDIA's data sheet, dense): the bounds are the larger of
# bytes over the memory rate and operations over the peak rate of their
# type
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = 67e12  # float32 without tensor cores
BF16_PEAK = 989e12  # bf16 tensor cores


def bound_ms(nbytes: float, ops: float, peak: float):
    """(least time in ms, "bytes" or "operations") for moving ``nbytes``
    and doing ``ops`` operations at ``peak`` per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# a sleep on the device ahead of each timed call, longer than the host
# takes to enqueue the call (~2 ms at the card's clock): the events then
# bracket the call's device work, not the host's launch overhead, which
# exceeds the device time of the small shapes
SLEEP_CYCLES = 4_000_000


def device_times_ms(fn, reps=20, warmup=3):
    """Device time of each of `reps` calls of fn() in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


_SMI_ROW = re.compile(r"\s*(\d{4}/\d\d/\d\d \d\d:\d\d:\d\d\.\d+)\s*,"
                      r"\s*([\d.]+)\s*,\s*([\d.]+)\s*")


def window_samples(lines, t0: float, t1: float) -> list:
    """The (clocks.sm, power.draw) of the lines of ``nvidia-smi
    --query-gpu=timestamp,clocks.sm,power.draw --format=csv,noheader,nounits``
    whose timestamp (the host's local time) lies in [t0, t1], seconds since
    the epoch; lines of another form are passed over."""
    rows = []
    for line in lines:
        m = _SMI_ROW.fullmatch(line)
        if m is None:
            continue
        t = datetime.datetime.strptime(m.group(1),
                                       "%Y/%m/%d %H:%M:%S.%f").timestamp()
        if t0 <= t <= t1:
            rows.append((float(m.group(2)), float(m.group(3))))
    return rows


def sampled_clocks(fn, seconds=1.0) -> str:
    """clocks.sm and power.draw as nvidia-smi samples them every 50 ms
    while ``fn`` runs back to back for ``seconds``: whether the card held
    its clock through a timing window.  A sample counts if its timestamp
    lies between the end of a first call of ``fn`` and the end of the
    last."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        while time.time() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        t1 = time.time()
        time.sleep(0.1)  # the last samples of the window reach the pipe
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = window_samples(out.splitlines(), t0, t1)
    if not rows:
        return "clocks.sm not sampled"
    clk, pw = zip(*rows)
    return (f"clocks.sm median {statistics.median(clk):.0f} MHz (min "
            f"{min(clk):.0f}, max {max(clk):.0f}), power.draw median "
            f"{statistics.median(pw):.1f} W, {len(rows)} samples")
