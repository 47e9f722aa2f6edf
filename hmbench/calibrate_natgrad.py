"""The readings a natural-gradient cell's limits are set from, in one
process on the card:

    python3 -m hmbench.calibrate_natgrad --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out <file.json>]

For each seed of ``--seeds``, the program's numbers (``kinds/
train_natgrad.py``'s ``numbers``, what a run compares) against the float64
natural-gradient reference: the lower readings.  For each seed of
``--control-seeds`` also the control's numbers (the reference in TF32 put
in the program's place) and two faults', planted in the reference put in
the program's place: each batch's second half left out and the rest scaled
up (``half_batch``), and every VE step's update skipped, q and S^{-1}
kept, as a step whose two attempts both fail leaves them
(``q_unchanged``).  No window is measured.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from hmbench.run import Spec, cache_dirs


def readings(spec, seeds, control_seeds, dev) -> dict:
    from hmbench.kinds import train_natgrad as kind

    out = {"sound": {}, "control": {}, "half_batch": {}, "q_unchanged": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        s = kind.build(spec.cfg, spec.mix, seed, dev)
        s.trainer = s.state = s.dataset = None
        if dev == "cuda":
            torch.cuda.empty_cache()
        ref = kind.reference(s)
        if seed in seeds:
            out["sound"][seed] = kind.numbers(s.prog, ref, s.p0)
        if seed in control_seeds:
            out["control"][seed] = kind.numbers(kind.reference(s, "tf32"), ref, s.p0)
            out["half_batch"][seed] = kind.numbers(kind.reference(s, half=True), ref, s.p0)
            out["q_unchanged"][seed] = kind.numbers(kind.reference(s, skip_ve=True),
                                                    ref, s.p0)
        print(f"[{time.perf_counter():.1f} s]", seed, {k: v.get(seed) for k, v in out.items()},
              file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cache_dirs()
    seeds = [int(x) for x in args.seeds.split(",") if x]
    control = [int(x) for x in args.control_seeds.split(",") if x]
    spec = Spec(args.workload)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    groups = {g: runs for g, runs in readings(spec, seeds, control, dev).items() if runs}
    names = {g: next(iter(runs.values())) for g, runs in groups.items()}
    largest = {g: {n: max(r[n] for r in runs.values()) for n in names[g]}
               for g, runs in groups.items()}
    smallest = {g: {n: min(r[n] for r in runs.values()) for n in names[g]}
                for g, runs in groups.items()}
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0)
              if dev == "cuda" else "cpu", "readings": groups,
              "largest": largest, "smallest": smallest}
    text = json.dumps(result, indent=1, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({"largest": largest, "smallest": smallest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
