"""A/B of two checkouts on one card: chip_smoke.py's phases, in turns.

    python3 -m hetmogp_tpu_torch.probes.ab_phases --parent DIR
        [--phases serving,high,highest,eager,natgrad,factor]
        [--out chiprun_out/ab]

Runs ``chip_smoke.py``'s phases from the checkout at DIR (another commit
unpacked with ``git archive``, "parent") and from this one ("change") in
the order parent, change, change, parent: one process a side, each
building its own kernels (``build_phase``), then each phase in a ``try``,
so that a phase that fails on one side (a profile check, say) does not end
the turns of the others.  The phases: ``serving`` (``serving_phase``:
rows/s, the pass's profile), ``high`` and ``highest``
(``graphed_trainer_phase`` at that precision: steps/s over its timed calls
and the profile of a 50-step call); and three written here from helpers
both checkouts' ``chip_smoke.py`` have: ``eager`` (the host-loop trainer,
``make_trainer`` at "highest", as ``training_phase`` times it: steps/s
over HOST_TIMED calls of 100 steps after one to warm up, and the profile
of a call), ``natgrad`` (the natural-gradient trainer with the "exact"
retraction, ``make_scan_trainer`` at "high": steps/s over 3 calls of
1,000 steps after the capturing one, the profile of a 50-step call, and
CUDA events of one exact attempt, ``attempt_ms``) and ``factor`` (the
factorization: cuSOLVER's ``potrf`` (``torch.linalg.cholesky_ex``)
profiled at the batch shapes of FACTOR_SHAPES, the kernels it launches;
in turns, medians of 40 by CUDA events behind a device sleep, ``potrf``,
``potrf`` and ``trsm`` against I, the checkout's
``linalg.blocked_cholesky_inverse`` (the refresh) of the flagship's Kuu,
and ``cholesky_ex`` and ``trsm`` of its first diagonal panel; the refresh
profiled, and timed as a replayed CUDA graph).  Each side's whole output
goes to
``<out>/<turn>_<side>.log``; the lines that carry the end-to-end numbers
and the profiles' totals and rows of kernels A, 3, 4, 5, 6, 8 and 9
(and of kernel 3's split pre-pass), and of cuBLAS's sgemm and trsm and
cuSOLVER's potrf kernels, are printed here, with the card's name and power
limit.
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
          "highest": "c.graphed_trainer_phase(smi, 'highest', timed_calls=3)",
          "eager": "host_loop_phase(c, smi)",
          "natgrad": "natgrad_exact_phase(c, smi)",
          "factor": "factor_library_phase(c, smi)"}
HOST_TIMED = 5  # the host loop's timed calls
# The (Q, M) of the factorizations the port runs: a refresh of the
# flagship's (Luu, iLuu) (and natgrad's "exact" attempt, at the same Q),
# one diagonal panel of it, a rank of the (2, 2) mesh, rank 2's 8 latents.
FACTOR_SHAPES = {"refresh (4, 1024, 1024)": (4, 1024),
                 "panel (4, 128, 128)": (4, 128),
                 "mesh rank (2, 1024, 1024)": (2, 1024),
                 "rank 2 (8, 1024, 1024)": (8, 1024)}
# The phases written here, run on either side with that side's
# ``chip_smoke`` as ``c`` and its ``hetmogp_tpu_torch``.
PRELUDE = f"""
import time
import torch

HOST_TIMED = {HOST_TIMED}
FACTOR_SHAPES = {FACTOR_SHAPES!r}
""" + '''

def host_loop_phase(c, smi):
    import hetmogp_tpu_torch as tp

    cfg, tc, params, dataset = c.training_model()
    sizes = (c.TRAIN_N_PER,) * cfg.num_tasks
    batches = (c.TRAIN_B,) * cfg.num_tasks
    run = tp.make_trainer(cfg, tc, sizes, batches,
                          steps_per_call=c.HOST_CALL_STEPS)
    state = tp.init_train_state(params, cfg)
    gen = torch.Generator().manual_seed(c.SEED + 2)
    state, _ = run(state, dataset, gen)
    torch.cuda.synchronize()
    rates = []
    for _ in range(HOST_TIMED):
        t0 = time.perf_counter()
        state, _ = run(state, dataset, gen)
        torch.cuda.synchronize()
        rates.append(c.HOST_CALL_STEPS / (time.perf_counter() - t0))
    c.report_rates('host-loop trainer (make_trainer, "highest")', rates,
                   c.HOST_CALL_STEPS, smi)
    c.profile(lambda: run(state, dataset, gen),
              f"host-loop trainer, {c.HOST_CALL_STEPS} steps", smi)


def natgrad_exact_phase(c, smi):
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

    cfg, _, params, dataset = c.training_model(precision="high")
    sizes = (c.TRAIN_N_PER,) * cfg.num_tasks
    batches = (c.TRAIN_B,) * cfg.num_tasks
    tc = tp.TrainConfig(**c.NATGRAD_TC, natgrad_retraction="exact")
    what = ('natgrad trainer (make_scan_trainer, "high", exact, natgrad_lr '
            f'{tc.natgrad_lr})')
    run = tp.make_scan_trainer(cfg, tc, sizes, batches,
                               steps_per_call=c.GRAPH_CALL_STEPS, vem=True)
    gen = torch.Generator().manual_seed(c.SEED + 21)
    state, _ = run(tp.init_train_state(params, cfg, tc, cache_luu=True),
                   dataset, gen)
    torch.cuda.synchronize()
    rates = []
    for _ in range(c.NATGRAD_CALLS):
        t0 = time.perf_counter()
        state, _ = run(state, dataset, gen)
        torch.cuda.synchronize()
        rates.append(c.GRAPH_CALL_STEPS / (time.perf_counter() - t0))
    c.report_rates(what, rates, c.GRAPH_CALL_STEPS, smi)
    offsets = ttrain.draw_offset_stream(gen, sizes, batches, c.PROFILE_STEPS)
    held = {}
    c.profile_replays(run, lambda: held.update(
        out=run(state, dataset, offsets=offsets)),
        f"{what}, one call of {c.PROFILE_STEPS} steps", smi)
    state = held["out"][0]
    p = state.params
    cost = c.attempt_ms(state.S_inv, torch.tril(p.q_sqrt), p.q_mu,
                        cfg.jitter, tc.natgrad_lr)
    print(f"natgrad exact attempt: {cost['exact']:.4f} ms of device time "
          f"(cholesky attempt {cost['cholesky']:.4f}), median of 20 "
          f"[card: {smi}]")


def factor_library_phase(c, smi):
    from hetmogp_tpu_torch.models import elbo
    from hetmogp_tpu_torch.ops import linalg

    cfg, params, _ = c.serving_model()
    with torch.no_grad():
        K = elbo._jittered_gram(params, cfg)
    q0, m0 = K.shape[0], K.shape[-1]
    for name, (q, m) in FACTOR_SHAPES.items():
        Kq = (torch.cat([K, K]) if q > q0 else K[:q])[:, :m, :m]
        Kq = Kq.contiguous()
        c.profile(lambda: torch.linalg.cholesky_ex(Kq),
                  f"factorization, cholesky_ex (cuSOLVER potrf) at {name}",
                  smi)
    eye = torch.eye(m0, device="cuda").expand_as(K)
    panel = K[:, :128, :128].contiguous()
    panel_eye = torch.eye(128, device="cuda").expand_as(panel)

    def refresh():
        return linalg.blocked_cholesky_inverse(K)

    t, n = c.time_in_turns({
        "potrf (4, 1024, 1024)": lambda: torch.linalg.cholesky_ex(K),
        "potrf and trsm against I (4, 1024, 1024)":
            lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(K)[0], eye, upper=False),
        "refresh, blocked_cholesky_inverse (4, 1024, 1024)": refresh,
        "potrf and trsm against I (4, 128, 128)":
            lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(panel)[0], panel_eye, upper=False)})
    print(f"factorization, device ms (median of {n}, in turns): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f" [card: {smi}]")
    c.profile(refresh, "factorization, blocked_cholesky_inverse (4, 1024, "
              "1024)", smi)
    refresh()  # warm-up: the handles, the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        refresh()
    tg, n = c.time_in_turns({"refresh graph": graph.replay})
    print(f"factorization, blocked_cholesky_inverse (4, 1024, 1024) as a "
          f"replayed CUDA graph: {tg['refresh graph']:.4f} device ms "
          f"(median of {n}) [card: {smi}]")
'''
# the lines each side's log is read for
KEEP = re.compile(r"throughput|profile: .* ms of kernel time|"
                  r"tril_right_tma_kernel|tril_right3_tma_kernel|"
                  r"tril_proj3_tma_kernel|tril_split_bf16_kernel|"
                  r"tril_proj_tma_kernel|tril_out_tma_kernel|"
                  r"tril_out3_tma_kernel|sgemm|trsm|"
                  r"gh_sweep_kernel|ve_tasks_kernel|ve_tasks_grad_kernel|"
                  r"potrf|chol_panel_kernel|factorization|exact attempt|"
                  r"PHASE")


def side_script(phases) -> str:
    body = "".join(
        f"try:\n    {PHASES[p]}\n    print('PHASE {p}: ok')\n"
        f"except Exception as e:\n    failed += 1\n"
        f"    print('PHASE {p}: FAILED', type(e).__name__, e)\n"
        for p in phases)
    return ("import sys\nimport chip_smoke as c\n" + PRELUDE
            + "smi = c.device_phase()\nc.build_phase(smi)\nfailed = 0\n"
            + body + "sys.exit(1 if failed else 0)\n")


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
