"""Traffic kind "train": the program's graphed scan trainer
(``make_scan_trainer``) driven by whole calls of ``steps_per_call`` steps,
back to back, one caller, slice offsets drawn from the seed.

Set-up builds the trainer and its state from the seed and drives them
through the checked steps, from step ``first_step`` of the schedule, as
calls of ``check_calls`` steps each (the first alone, so that adam's
state after it holds the first gradient of the leaves it frees; the next
steps in one call, through the same in-call loop as the window's), on
rows that all differ: each step's offsets lie in its own part of every
task.  Then whole calls for ``warm_seconds``; the same trainer and state
then run the window.  Each call ends at
a synchronize: ``train_steps_per_s`` is every step of the window over the
window's wall time.  After the window: the peak memory, the traced call
and the per-layer readings (``--trace 1``), the program freed, then the
reference follows the checked steps from the same initial parameters and
rows.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from hmbench import check, inputs, port, trace
from hmbench.kinds import Result
from hmbench.reference import svgp
from hmbench.roofline import launchers, svmogp


def free_vm(t: dict) -> tuple:
    """The leaves a VM step frees."""
    free = ("log_lengthscale", "log_variance", "Z", "W")
    return free + (("lik_theta",) if t.get("learn_lik_params") else ())


def prepare(cfg: dict, mix: dict, seed: int, dev):
    """The inputs from the seed: the initial parameters, the task data and
    the checked steps' offsets (each step's rows in its own third of every
    task) and kinds."""
    t = cfg["train"]
    gen = inputs.generator(seed, dev)
    p0 = inputs.init_params(cfg, gen, dev)
    data = inputs.task_data(cfg, gen, dev)
    T, N, B = len(data), cfg["rows_per_task"], t["batch_per_task"]
    s = SimpleNamespace(cfg=cfg, p0=p0, data=data, T=T, N=N, B=B,
                        K=mix["steps_per_call"], rng=np.random.default_rng(seed))
    n, cycle = sum(mix["check_calls"]), t["ve_steps_per_vm"] + 1
    part = N // n
    s.offsets = [s.rng.integers(i * part, (i + 1) * part - B, size=T) for i in range(n)]
    s.kinds = ["ve" if (mix["first_step"] + i) % cycle < cycle - 1 else "vm"
               for i in range(n)]
    return s


def build(cfg: dict, mix: dict, seed: int, dev, log=lambda what: None):
    """``prepare``, then the trainer and its state, driven through the
    checked steps in the mix's calls; the launches its graphs' capture
    recorded."""
    import hetmogp_tpu_torch as tp

    port.load_kernels(dev)
    log("kernel library loaded")
    s = prepare(cfg, mix, seed, dev)
    log("inputs made")
    s.config = port.model_config(cfg, cfg["train"]["ve_fwd_precision"])
    tc = port.train_config(cfg)
    s.dataset = port.dataset(s.data)
    s.trainer = tp.make_scan_trainer(s.config, tc, (s.N,) * s.T, (s.B,) * s.T,
                                     steps_per_call=s.K)
    s.state = port.init_state(port.params(s.p0), s.config, tc, mix["first_step"])
    if [s.trainer.kind(mix["first_step"] + i) for i in range(len(s.kinds))] != s.kinds:
        raise RuntimeError("the trainer's schedule is not the configuration's")
    elbos, calls, i = [], [], 0
    for n in mix["check_calls"]:
        offs = torch.from_numpy(np.stack(s.offsets[i:i + n]))
        with port.record_launches() as recorded:
            s.state, e = s.trainer(s.state, s.dataset, offsets=offs)
        if i == 0:
            s.recorded = recorded  # the first call captures the graphs
        elbos += [float(x) for x in e[:n]]
        calls.append((s.kinds[i:i + n], port.adam_moments(s.state)))
        i += n
        log(f"checked steps {i - n + 1}-{i} done")
    after = {k: v.detach().clone() for k, v in port.param_leaves(s.state.params).items()}
    s.prog = (elbos, check.first_grads(calls, free_vm(cfg["train"])), after)
    return s


def call(s, steps=None):
    """One whole call of ``steps`` (the mix's call) steps; returns its
    ELBOs."""
    offs = torch.from_numpy(s.rng.integers(0, s.N, size=(steps or s.K, s.T)))
    s.state, e = s.trainer(s.state, s.dataset, offsets=offs)
    return e


def reference_steps(s, half=False):
    """The checked steps' (kind, batch, scales) for the reference; ``half``
    leaves out each batch's second half and scales the rest up (a fault)."""
    t = s.cfg["train"]
    b_vm = max(1, math.ceil(s.B * t["vm_batch_fraction"]))
    out = []
    for kind, off in zip(s.kinds, s.offsets):
        rows = s.B if kind == "ve" else b_vm
        rows = rows // 2 if half else rows
        batch = [(X[o:o + rows], Y[o:o + rows]) for (X, Y), o in zip(s.data, off.tolist())]
        out.append((kind, batch, [s.N / rows] * s.T))
    return out


def reference(s, precision="float64", half=False):
    """(ELBOs, first gradients, params after) of the reference."""
    ref = svgp.Reference(s.cfg, s.data[0][0].device, precision)
    return ref.train_steps(s.p0, reference_steps(s, half), free_vm(s.cfg["train"]),
                           s.cfg["train"]["step_rate"])


def _expected(trainer, replayed: dict) -> dict:
    launches = {}
    for kind, graph in trainer.capture_launches.items():
        for launcher, c in graph.items():
            launches[launcher] = launches.get(launcher, 0) + c * replayed[kind]
    return trace.expected_symbols(launches)


def run(ctx) -> Result:
    s = build(ctx.cfg, ctx.mix, ctx.seed, ctx.device, ctx.log)
    warm = time.perf_counter()
    while True:  # whole calls for warm_seconds: the first seconds under load run slow
        call(s)
        ctx.sync()
        if time.perf_counter() - warm >= ctx.mix["warm_seconds"]:
            break
    setup_s = ctx.elapsed()
    ctx.log("set-up done")

    steps, fails, host, rates = 0, 0, [], []
    t_start = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        e = call(s)
        c1 = time.perf_counter()  # the host has enqueued every replay
        ctx.sync()
        c2 = time.perf_counter()
        host.append((c1 - c0) / (c2 - c0))
        rates.append((round(ctx.elapsed(), 2), round(s.K / (c2 - c0), 1)))
        steps += s.K
        fails += int((~torch.isfinite(e)).sum())
        if c2 - t_start >= ctx.seconds:
            break
    window_s = c2 - t_start
    ctx.log(f"(end, steps/s) of each call: {rates}")
    res = Result(attempted=steps, failed=fails, setup_s=setup_s,
                 e2e={"train_steps_per_s": steps / window_s},
                 memory_peak_bytes=ctx.memory_peak())

    ctx.log("window done")
    if ctx.trace:
        last = {}

        def traced():
            last["before"] = dict(s.trainer.replays)
            call(s, ctx.mix["trace_steps"])

        def expected():
            last["replayed"] = {k: s.trainer.replays[k] - last["before"][k]
                                for k in s.trainer.replays}
            return _expected(s.trainer, last["replayed"])

        res.trace = ctx.take(traced, expected)
        ctx.log("trace done")
        t = ctx.cfg["train"]
        graphs, why = launchers.graph_tables(s.recorded, list(s.trainer.kinds),
                                             s.trainer.capture_launches)
        if graphs is None:
            ctx.log(f"roofline: {why}")
        res.layer.update(
            kind="train", cycle={"ve": t["ve_steps_per_vm"], "vm": 1},
            trace=res.trace, step_s=window_s / steps, host_shares=host,
            products=svmogp.step_products(ctx.cfg), graphs=graphs,
            replayed=last.get("replayed"),
            program=dict(config=s.config, state=s.state, dataset=s.dataset,
                         batch=(s.N,) * s.T, B=s.B, rng=s.rng,
                         repeats=ctx.mix["layer_repeats"]))
        ctx.read_layers(res)
        res.layer.clear()
    s.trainer = s.state = s.dataset = None
    ctx.free()
    ctx.log("program freed; the reference")
    res.checks = check.beside(check.train_numbers(s.prog, reference(s), s.p0), ctx.limits)
    return res
