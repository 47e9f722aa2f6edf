"""Set-up of the benchmark's own tests: the repository root on the path,
the ``card`` marker (a test that needs an NVIDIA GPU decides so inside the
test and skips without one), and a tiny copy of the benchmark's data files
for runs on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and hmbench/ copied to ``dest`` with every
    configuration and mix cut to a size a CPU test holds: M = 16, 600 rows
    a task, B = 32, calls of 5 steps after 0.2 s of warm-up, requests of 64
    and 128 rows."""
    shutil.copytree(ROOT / "hmbench", dest / "hmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    for p in (dest / "hmbench" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(num_inducing=16, rows_per_task=600)
        d.get("train", {})["batch_per_task"] = 32
        p.write_text(json.dumps(d))
    for p in (dest / "hmbench" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        if d["kind"] == "train":
            d.update(steps_per_call=5, warm_seconds=0.2)
        else:
            d.update(pool_rows=4096, sizes=[64, 128], keep_one_in=3)
        p.write_text(json.dumps(d))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)
