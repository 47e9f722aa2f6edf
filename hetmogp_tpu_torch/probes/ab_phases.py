"""A/B of two checkouts on one card: chip_smoke.py's phases, in turns.

    python3 -m hetmogp_tpu_torch.probes.ab_phases --parent DIR
        [--phases serving,high,highest] [--out chiprun_out/ab]

Runs ``chip_smoke.py``'s phases from the checkout at DIR (another commit
unpacked with ``git archive``, "parent") and from this one ("change") in
the order parent, change, change, parent: one process a side, each
building its own kernels (``build_phase``), then each phase in a ``try``,
so that a phase that fails on one side (a profile check, say) does not end
the turns of the others.  The phases: ``serving`` (``serving_phase``:
rows/s, the pass's profile), ``high`` and ``highest``
(``graphed_trainer_phase`` at that precision: steps/s over its timed calls
and the profile of a 50-step call).  Each side's whole output goes to
``<out>/<turn>_<side>.log``; the lines that carry the end-to-end numbers
and the profiles' totals and rows of kernels A, 3, 4, 5, 6 and 8 (and
of kernel 3's split pre-pass), and of cuBLAS's sgemm and trsm kernels,
are printed here, with the card's name and power limit.
Exits non-zero if any phase failed.

A measurement script run by hand from a checkout: the packaging leaves
this directory out of an installed ``hetmogp_tpu_torch``.  Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
PHASES = {"serving": "c.serving_phase(smi)",
          "high": "c.graphed_trainer_phase(smi, 'high', timed_calls=5)",
          "highest": "c.graphed_trainer_phase(smi, 'highest', timed_calls=3)"}
# the lines each side's log is read for
KEEP = re.compile(r"throughput|profile: .* ms of kernel time|"
                  r"tril_right_tma_kernel|tril_right3_tma_kernel|"
                  r"tril_proj3_tma_kernel|tril_split_bf16_kernel|"
                  r"tril_proj_tma_kernel|tril_out_tma_kernel|"
                  r"tril_out3_tma_kernel|sgemm|trsm|"
                  r"gh_sweep_kernel|ve_tasks_kernel|ve_tasks_grad_kernel|"
                  r"PHASE")


def side_script(phases) -> str:
    body = "".join(
        f"try:\n    {PHASES[p]}\n    print('PHASE {p}: ok')\n"
        f"except Exception as e:\n    failed += 1\n"
        f"    print('PHASE {p}: FAILED', type(e).__name__, e)\n"
        for p in phases)
    return ("import sys\nimport chip_smoke as c\nsmi = c.device_phase()\n"
            "c.build_phase(smi)\nfailed = 0\n" + body +
            "sys.exit(1 if failed else 0)\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--phases", default="serving,high,highest")
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "ab")
    args = ap.parse_args()
    phases = args.phases.split(",")
    args.out.mkdir(parents=True, exist_ok=True)
    sides = {"parent": args.parent.resolve(), "change": HERE}
    failed = 0
    for turn, side in enumerate(("parent", "change", "change", "parent")):
        log = args.out / f"{turn}_{side}.log"
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "-c", side_script(phases)],
                                cwd=sides[side], stdout=f,
                                stderr=subprocess.STDOUT).returncode
        failed += rc != 0
        lines = log.read_text().splitlines()
        card = next((ln for ln in lines if ln.startswith("card: ")), "")
        print(f"turn {turn}, {side} ({sides[side]}): exit {rc}; {card}")
        for ln in lines:
            if KEEP.search(ln):
                print(f"  {ln.strip()}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
