"""Tracing, profiling and numerical-debug hooks.

Counterpart of ``hetmogp_tpu/profiling.py``:

* ``trace(logdir)``: profile the block with ``torch.profiler`` (the CPU,
  and the card where there is one) and write a Chrome trace into
  ``logdir``;
* ``annotate(name)``: a named region in such traces
  (``torch.profiler.record_function``), and an NVTX range on the card;
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
import re
import statistics
import subprocess
import time
from pathlib import Path
from typing import Any

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything in the block; the trace goes to
    ``{logdir}/trace_<time>.json`` (Chrome's trace format, which
    TensorBoard's and Perfetto's viewers read)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region for traces: ``with annotate('ve_step'): ...``.  Nests."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
