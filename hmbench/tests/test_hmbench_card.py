"""The command itself: without a card it exits non-zero and prints no
result; on a card (marked ``card``: it skips without one, deciding so
inside the test) one short run of a cell prints a correct result line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

COMMAND = [sys.executable, "-m", "hmbench.run", "--workload", "lmc6-serve",
           "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace", "0"]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    out = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"serve_rows_per_s", "serve_p95_ms", "setup_s"}
