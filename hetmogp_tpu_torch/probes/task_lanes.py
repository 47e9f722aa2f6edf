"""Kernel 6's task table: the lanes a row, timed in turns.

    python3 -m hetmogp_tpu_torch.probes.task_lanes

The task table (``csrc/ve_tasks_kernel.cu``) gives each row of a swept
family L lanes of a 256-thread block, the nodes strided over them, the
lanes' sums meeting in a fixed tree in shared memory
(``ops/cuda_kernels.py::task_lanes`` picks L: one node a lane).  This
probe times the forward launch, with the gradient coefficients and the
value alone, on the flagship's six tasks at the VE (6 x 512 rows), VM
(6 x 128) and fused (6 x 3072) shapes of ``chip_smoke.py``'s
``TASK_ROWS``, float32, for each mapping of ``VARIANTS`` (the lanes of
Bernoulli's 20 nodes, Categorical's 100, Gamma's lngamma 20), every
variant in turns with the others (CUDA events behind a device sleep,
medians), and checks each against the default mapping's sums (they
differ only in the order of each row's node sums).  Prints the card's
name and power limit beside every number.

A measurement script run by hand from a checkout: the packaging leaves
this directory out of an installed ``hetmogp_tpu_torch``.  Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# (Bernoulli, Categorical K=3, Gamma's lngamma): one node a lane (the
# default), a warp a row (the per-engine design's mapping), two, four and
# five nodes a lane, and 128 lanes for Categorical (a power of two)
VARIANTS = {"one node a lane": (20, 100, 20), "a warp a row": (32, 32, 32),
            "two nodes a lane": (10, 50, 10), "four or five": (5, 25, 5),
            "Categorical on 128": (20, 128, 20)}


def main() -> int:
    import chip_smoke as c
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    smi = c.device_phase()
    c.build_phase(smi)
    liks = c.task_liks()
    swept = [t for t, lik in enumerate(liks)
             if quadrature.TASK_FAMILIES[quadrature.task_family(lik)][2]]
    for label in ("VE", "VM", "fused"):
        rows = c.TASK_ROWS[label]
        Y, M, V, masks, scales = (
            [a.float() for a in x] if isinstance(x, list) else x.float()
            for x in c.task_inputs(rows, c.SEED + 90, False, False))
        tasks, sc = quadrature._task_launch_args(liks, Y, M, V, masks,
                                                 list(scales))
        lanes = {}
        for name, per in VARIANTS.items():
            full = [1] * len(liks)
            for t, L in zip(swept, per):
                full[t] = L
            lanes[name] = full
        base = ck.task_var_exp(tasks, sc)[0]
        fns = {}
        for name, full in lanes.items():
            got = ck.task_var_exp(tasks, sc, lanes=full)[0]
            err = float(((got - base).abs() / base.abs()).max())
            print(f"{label}, lanes {name} {full}: sums vs the default "
                  f"mapping, largest relative difference {err:.3e} "
                  f"[card: {smi}]")
            fns[name] = lambda full=full: ck.task_var_exp(tasks, sc,
                                                          lanes=full)
            fns[name + ", value"] = (
                lambda full=full: ck.task_var_exp_value(tasks, sc,
                                                        lanes=full))
        fns["empty kernel"] = ck.empty_launch
        samples = {k: [] for k in fns}
        order = list(fns.items())
        for _ in range(3):
            for k, f in order + order[::-1]:
                samples[k] += c.device_times_ms(f)
        for k, v in samples.items():
            print(f"{label} ({sum(rows)} rows, float32), {k}: median "
                  f"{statistics.median(v):.4f} ms, min {min(v):.4f}, max "
                  f"{max(v):.4f}, {len(v)} calls [card: {smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
