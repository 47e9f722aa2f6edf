"""The readings a cell's limits are set from, in one process on the card:

    python3 -m hmbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out <file.json>]

For each seed of ``--seeds``, the program's numbers (what a run compares)
against the float64 reference: the lower readings.  For each seed of
``--control-seeds`` also the control's numbers (the reference in TF32 put
in the program's place) and the faults': for training, each batch's second
half left out and the rest scaled up (planted in the reference put in the
program's place; a state left unchanged reads 1 on ``change`` by
construction); for serving, one row of one answer altered and half of each
answer's rows left out (zeros), planted in the program's answers.  No
window is measured.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from hmbench import check
from hmbench.reference import svgp
from hmbench.run import Spec, cache_dirs


def _train(spec, seeds, control_seeds, dev):
    from hmbench.kinds import train

    out = {"sound": {}, "control": {}, "half_batch": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        s = train.build(spec.cfg, spec.mix, seed, dev)
        s.trainer = s.state = s.dataset = None
        torch.cuda.empty_cache()
        ref = train.reference(s)
        if seed in seeds:
            out["sound"][seed] = check.train_numbers(s.prog, ref, s.p0)
        if seed in control_seeds:
            out["control"][seed] = check.train_numbers(train.reference(s, "tf32"), ref, s.p0)
            out["half_batch"][seed] = check.train_numbers(train.reference(s, half=True),
                                                          ref, s.p0)
        print(f"[{time.perf_counter():.1f} s]", seed, {k: v.get(seed) for k, v in out.items()},
              file=sys.stderr, flush=True)
    return out


def _altered(m):
    m = m.clone()
    m[0] = m[1]
    return m


def _halved(m):
    m = m.clone()
    m[m.shape[0] // 2:] = 0.0
    return m


def _serve(spec, seeds, control_seeds, dev):
    from hmbench.kinds import serve_closed

    out = {"sound": {}, "control": {}, "altered": {}, "half_rows": {}}
    blocks = 4 * len(spec.mix["sizes"]) * len(spec.cfg["likelihoods"])
    for seed in sorted(set(seeds) | set(control_seeds)):
        s = serve_closed.build(spec.cfg, spec.mix, seed, dev)
        kept = [serve_closed.serve(s, next(s.sched)) for _ in range(blocks)]
        s.fns = None
        torch.cuda.empty_cache()
        ref = svgp.Reference(spec.cfg, dev, "float64")
        if seed in seeds:
            out["sound"][seed] = check.serve_numbers(ref, s.p0, kept)
        if seed in control_seeds:
            ref32 = svgp.Reference(spec.cfg, dev, "tf32")
            ctl = [(t, X, *ref32.served(s.p0, X, t)) for t, X, _, _ in kept]
            out["control"][seed] = check.serve_numbers(ref, s.p0, ctl)
            out["altered"][seed] = check.serve_numbers(
                ref, s.p0, [(t, X, _altered(m), _altered(v)) for t, X, m, v in kept])
            out["half_rows"][seed] = check.serve_numbers(
                ref, s.p0, [(t, X, _halved(m), _halved(v)) for t, X, m, v in kept])
        print(seed, {k: v.get(seed) for k, v in out.items()}, file=sys.stderr, flush=True)
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
    kind = spec.mix["kind"]
    readings = (_train if kind == "train" else _serve)(spec, seeds, control, dev)
    groups = {g: runs for g, runs in readings.items() if runs}
    summary = {g: {n: max(r[n] for r in runs.values()) for n in next(iter(runs.values()))}
               for g, runs in groups.items()}
    low = {g: {n: min(r[n] for r in runs.values()) for n in next(iter(runs.values()))}
           for g, runs in groups.items()}
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0)
              if dev == "cuda" else "cpu", "readings": readings,
              "largest": summary, "smallest": low}
    text = json.dumps(result, indent=1, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({"largest": summary, "smallest": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
