"""Structured training metrics and logging.

Counterpart of ``hetmogp_tpu/metrics.py``: every step's metrics dict
(elbo, kl, per-task VE, ...) goes to a pluggable logger, here one that
keeps the history and optionally prints and writes JSON lines.  Pass it as
``svi_fit(callback=...)``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, List, Optional

import numpy as np


class MetricsLogger:
    """Collects per-step metrics; optionally prints / writes JSONL."""

    def __init__(self, print_every: int = 50, jsonl_path: Optional[str] = None,
                 printer: Callable[[str], None] = print):
        self.print_every = print_every
        self.jsonl_path = jsonl_path
        self.printer = printer
        self.history: List[dict] = []
        self._t0 = time.perf_counter()
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def __call__(self, step: int, metrics: dict):
        rec = {"step": int(step), "time": time.perf_counter() - self._t0}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                # a vector metric (the per-task VE); a tensor of several
                # elements raises on float() where an array raises
                # TypeError
                rec[k] = [float(x) for x in v]
        self.history.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self.print_every and (step + 1) % self.print_every == 0:
            e = rec.get("elbo")
            shown = f"{e:.4f}" if isinstance(e, (int, float)) else "n/a"
            self.printer(f"svi - iteration {step + 1}: elbo={shown}")

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @property
    def elbo(self) -> np.ndarray:
        return np.asarray([r.get("elbo", float("nan")) for r in self.history])
