"""Shared arithmetic of the per-layer readers (not a metric: no
BENCHMARK.json entry names it)."""

from __future__ import annotations

import sys
from collections import Counter


def idle_percent(layer: dict, kind: str):
    tr = layer.get("trace")
    if layer.get("kind") != kind or tr is None:
        return None
    return 100.0 * tr.idle_share


def roofline_percent(tr, counts: dict):
    """100 * the least time of the launches over the device time of the
    hand kernels they name, when the trace shows exactly those launches.
    counts: {key: (entries, n)}, each list of (least ms, symbol, calls)
    run n times in the trace."""
    want, least = Counter(), 0.0
    for ents, n in counts.values():
        for ms, sym, calls in ents:
            want[sym] += calls * n
            least += ms * n
    off = {s: (tr.calls(s), c) for s, c in want.items() if tr.calls(s) != c}
    if off:
        print(f"roofline: the trace's hand-kernel calls (seen, launched) differ: "
              f"{off}", file=sys.stderr)
        return None
    measured = sum(tr.by_symbol[s][0] for s in want) * 1e3
    return 100.0 * least / measured if measured > 0 else None
