"""The traced window: torch.profiler over whole calls, reduced to the
device's busy time (the union of its activities' intervals), the time by
operation name, the idle gaps by the activity that ended each, and the
calls and time of each of the program's hand kernels by device symbol.

The profiler can drop the device records of CUDA-graph replays at random;
``take`` holds the calls of each hand kernel in a trace to the launches
that the program's counters expect and takes the trace again, up to four
times, when it shows fewer.  A trace starts with the program's empty
kernel, before the window: the first replay of a trace can otherwise go
unrecorded; and it ends with one, after the window: the last records can
otherwise go missing.
"""

from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass, field

import torch

TRIES = 4

# the device symbols each of the program's launchers (the keys of its
# launch counters) launches once a call
LAUNCHER_SYMBOLS = {
    "rbf_K_batched_vec": ("rbf_cross_vec_kernel",),
    "rbf_K_batched_scalar": ("rbf_cross_kernel",),
    "tril_projection_tma": ("tril_proj_tma_kernel",),
    "tril_projection_staged": ("tril_proj_kernel",),
    "tril_projection_3pass_tma": ("tril_proj3_tma_kernel", "tril_split_bf16_kernel"),
    "tril_projection_3pass_staged": ("tril_proj3_kernel",),
    "tril_right_tma": ("tril_right_tma_kernel",),
    "tril_right_generic": ("tril_right_generic_kernel",),
    "tril_right3_tma": ("tril_right3_tma_kernel",),
    "tril_right3_generic": ("tril_right3_generic_kernel",),
    "tril_out_tma": ("tril_out_tma_kernel",),
    "tril_out3_tma": ("tril_out3_tma_kernel",),
    "tril_out_generic": ("tril_out_generic_kernel",),
    "tril_out3_generic": ("tril_out_generic_kernel",),
    "gh_sweep": ("gh_sweep_kernel",), "gh_sweep_value": ("gh_sweep_kernel",),
    "task_var_exp": ("ve_tasks_kernel",), "task_var_exp_value": ("ve_tasks_kernel",),
    "task_var_exp_backward": ("ve_tasks_grad_kernel",),
    "adam_update": ("adam_kernel",), "chol_panel": ("chol_panel_kernel",)}
# kernel 4's row sums add their partials in a second kernel of the same entry
SYMBOLS = sorted({s for v in LAUNCHER_SYMBOLS.values() for s in v}
                 | {"row_sum_kernel"})
_PATTERNS = {s: re.compile(rf"(?<![A-Za-z_]){s}(?![a-z0-9_])") for s in SYMBOLS}


def symbol_of(name: str):
    for s, pat in _PATTERNS.items():
        if pat.search(name):
            return s
    return None


def expected_symbols(launches: dict) -> dict:
    """{device symbol: calls} of launcher counts {launcher: launches}."""
    out = {}
    for launcher, n in launches.items():
        for sym in LAUNCHER_SYMBOLS.get(launcher, ()):
            out[sym] = out.get(sym, 0) + n
    return {s: n for s, n in out.items() if n}


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    by_name: dict = field(default_factory=dict)  # name -> [seconds, calls]
    by_symbol: dict = field(default_factory=dict)  # symbol -> [seconds, calls]
    gaps: dict = field(default_factory=dict)  # name ending a gap -> seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def calls(self, sym: str) -> int:
        return self.by_symbol.get(sym, [0.0, 0])[1]

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v[0]] for n, v in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _device_events(prof) -> list:
    """(name, start us, end us) of every device activity, from the
    profiler's raw records (the event tree is not built: it takes minutes
    for a trace of a hundred thousand kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns() / 1e3
            out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return sorted(out, key=lambda e: e[1])


def _reduce(prof, window_s: float) -> Trace:
    evts = _device_events(prof)
    if evts and "empty_kernel" in evts[0][0]:
        evts = evts[1:]  # the leading empty kernel, before the window
    if evts and "empty_kernel" in evts[-1][0]:
        evts = evts[:-1]  # the trailing one, after it
    tr = Trace(window_s=window_s)
    if not evts:
        return tr
    busy, end = 0.0, evts[0][1]
    for name, s, e in evts:
        if s > end:
            tr.gaps[name] = tr.gaps.get(name, 0.0) + (s - end) * 1e-6
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        row = tr.by_name.setdefault(name, [0.0, 0])
        row[0] += (e - s) * 1e-6
        row[1] += 1
        sym = symbol_of(name)
        if sym is not None:
            srow = tr.by_symbol.setdefault(sym, [0.0, 0])
            srow[0] += (e - s) * 1e-6
            srow[1] += 1
    tr.busy_s = busy * 1e-6
    return tr


def trace_once(call, empty_launch) -> Trace:
    """One traced run of ``call``; its window is the host's clock from the
    call to the synchronize after it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        empty_launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        # a trailing empty kernel: the last records of a trace can
        # otherwise go missing with the profiler's stop
        empty_launch()
        torch.cuda.synchronize()
    return _reduce(prof, window)


def take(call, empty_launch, expected_after):
    """A trace of ``call`` in which each hand kernel shows all the calls
    that ``expected_after()`` ({symbol: calls}, read from the program's
    counters after the call) expects; None when none of TRIES traces does,
    when one shows more, or when the profiler saw no device time."""
    for attempt in range(1, TRIES + 1):
        tr = trace_once(call, empty_launch)
        if tr.busy_s <= 0.0:
            print("trace: the profiler saw no device time", file=sys.stderr)
            return None
        expected = expected_after()
        seen = {s: tr.calls(s) for s in expected}
        if seen == expected:
            return tr
        off = {s: (seen[s], expected[s]) for s in seen if seen[s] != expected[s]}
        print(f"trace {attempt} of {TRIES}: hand-kernel calls (seen, expected) "
              f"{off}", file=sys.stderr)
        if any(seen[s] > expected[s] for s in seen):
            return None
    return None
