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
  state) dataclass that names the offending leaf.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
