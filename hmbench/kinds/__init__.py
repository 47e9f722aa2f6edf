"""One generator a traffic kind: ``kinds/<kind>.py`` with ``run(ctx)``,
which builds the program from the cell's configuration and the seed,
warms up, measures for ``ctx.seconds``, traces (``ctx.trace``) and
returns a ``Result`` with the checks that decide ``correct``."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Result:
    attempted: int
    failed: int
    setup_s: float
    e2e: dict
    memory_peak_bytes: int
    checks: list = field(default_factory=list)  # (name, value, limit)
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    per_layer: dict = field(default_factory=dict)  # name -> value
    trace: object = None
