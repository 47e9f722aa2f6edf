"""Traffic kind "train_natgrad": the program's graphed scan trainer
(``make_scan_trainer``) built from the configuration's whole ``train``
block (``natgrad_adam``: natural gradients on q(u) by its retraction, adam
on the rest), driven as kind "train" drives it: whole calls of
``steps_per_call`` steps back to back, one caller, slice offsets from the
seed, the checked steps first (``train.prepare``), then ``warm_seconds``
of whole calls, the window, and with ``--trace 1`` the traced call and the
per-layer readings.  It exits at once where the program's natural-gradient
step forms its products at another precision than the configuration's
``natgrad_precision`` (``runs_as_stated``).

What decides ``correct``, against the float64 natural-gradient reference
(``reference/natgrad.py``) from the same initial parameters and rows:

* ``loss``: the worst relative gap of the checked steps' ELBOs;
* ``grad``: the VM step's first gradients, read from adam's first moments
  (a natural-gradient VE step frees no adam leaf), by leaf as
  ``check.train_numbers`` takes them;
* ``change``: the parameters' change over the checked steps by leaf, as
  ``check.train_numbers`` takes it: the hypers' over the elements their
  gradient resolves, q_sqrt's whole, and q_mu's by its natural parameter
  S^{-1} m (with the carried S^{-1}), which the step sets before any
  inversion: m' = S' theta_1' carries the products' error of theta_1',
  times the new precision's condition number, into the directions of m
  that the rows leave free (PERF.md, the cell's calibration);
* ``sinv``: the carried S^{-1} after the last checked step, normwise;
* ``backoff``: 0 where every checked VE step took the reference's attempt
  (the step at natgrad_lr, at natgrad_lr / 4, or none), inf otherwise.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from hmbench import check, port
from hmbench.kinds import Result
from hmbench.kinds.train import _expected, call, free_vm, prepare, reference_steps
from hmbench.reference import natgrad as ng_ref
from hmbench.reference import svgp
from hmbench.roofline import launchers, natgrad as ng_roof


def train_config(cfg: dict):
    """The program's TrainConfig from every key of the ``train`` block it
    has a field for."""
    import hetmogp_tpu_torch as tp

    fields = {f.name for f in dataclasses.fields(tp.TrainConfig)}
    return tp.TrainConfig(**{k: v for k, v in cfg["train"].items() if k in fields})


def runs_as_stated(cfg: dict) -> None:
    """Exits (SystemExit) unless the program's natural-gradient step forms
    its products at the configuration's ``natgrad_precision``, as the
    program's ``train.natgrad_precision`` gives it for the configuration's
    model and retraction: a program that cannot say, or forms them
    otherwise, does not run this configuration."""
    from hetmogp_tpu_torch import train as program

    t = cfg["train"]
    config = port.model_config(cfg, t["ve_fwd_precision"])
    which = getattr(program, "natgrad_precision", None)
    got = None if which is None else which(config, t["natgrad_retraction"])
    if got != t["natgrad_precision"]:
        raise SystemExit(
            f"the program's natural-gradient step forms its products at {got!r} "
            f"(None: it does not say); the configuration states "
            f"{t['natgrad_precision']!r}: the program does not run this configuration")


def build(cfg: dict, mix: dict, seed: int, dev, log=lambda what: None):
    """``train.prepare``, then the trainer and its state, driven through the
    checked steps in the mix's calls; the launches its graphs' capture
    recorded.  ``s.prog``: (ELBOs, first gradients, params after, S^{-1}
    after, the VE steps' backoff codes).  Exits first where the program
    does not run the configuration as stated (``runs_as_stated``)."""
    import hetmogp_tpu_torch as tp

    runs_as_stated(cfg)
    port.load_kernels(dev)
    log("kernel library loaded")
    s = prepare(cfg, mix, seed, dev)
    log("inputs made")
    s.config = port.model_config(cfg, cfg["train"]["ve_fwd_precision"])
    tc = train_config(cfg)
    s.dataset = port.dataset(s.data)
    s.trainer = tp.make_scan_trainer(s.config, tc, (s.N,) * s.T, (s.B,) * s.T,
                                     steps_per_call=s.K)
    s.state = port.init_state(port.params(s.p0), s.config, tc, mix["first_step"])
    if [s.trainer.kind(mix["first_step"] + i) for i in range(len(s.kinds))] != s.kinds:
        raise RuntimeError("the trainer's schedule is not the configuration's")
    elbos, calls, codes, i = [], [], [], 0
    for n in mix["check_calls"]:
        offs = torch.from_numpy(np.stack(s.offsets[i:i + n]))
        with port.record_launches() as recorded:
            s.state, e = s.trainer(s.state, s.dataset, offsets=offs)
        if i == 0:
            s.recorded = recorded  # the first call captures the graphs
        elbos += [float(x) for x in e[:n]]
        codes += [int(c) for c, k in zip(s.trainer.ng_backoff[:n].tolist(),
                                         s.kinds[i:i + n]) if k == "ve"]
        calls.append((s.kinds[i:i + n], port.adam_moments(s.state)))
        i += n
        log(f"checked steps {i - n + 1}-{i} done")
    after = {k: v.detach().clone() for k, v in port.param_leaves(s.state.params).items()}
    grads = {k: v for k, v in check.first_grads(calls, free_vm(cfg["train"])).items()
             if k.split(".")[0] not in svgp.VE_FREE}
    s.prog = (elbos, grads, after, s.state.S_inv.detach().clone(), codes)
    return s


def reference(s, precision="float64", half=False, skip_ve=False):
    """(ELBOs, first gradients, params after, S^{-1} after, codes) of the
    reference; ``half`` and ``skip_ve`` are faults (``train.reference_steps``;
    q kept at every VE step)."""
    ref = ng_ref.Reference(s.cfg, s.data[0][0].device, precision)
    return ref.train_steps(s.p0, reference_steps(s, half), free_vm(s.cfg["train"]),
                           s.cfg["train"]["step_rate"], skip_ve=skip_ve)


def numbers(prog: tuple, ref: tuple, p0: dict) -> dict:
    """prog, ref: (ELBOs, {leaf: first gradient}, params after, S^{-1}
    after, codes) of the checked steps; p0: the initial params."""
    (e_p, g_p, a_p, s_p, c_p), (e_r, g_r, a_r, s_r, c_r) = prog, ref
    init = {k: v for k, v in p0.items() if k != "lik_theta"}
    dev = next(iter(init.values())).device
    g_p = {k: v.to(dev) for k, v in g_p.items() if v.numel()}
    g_r = {k: v.to(dev) for k, v in g_r.items() if v.numel()}
    mask = check.resolved(g_p, g_r)

    def natural(m, s_inv):  # the mean's natural parameter S^{-1} m
        return (s_inv.to(dev).double() @ m.to(dev).double()[..., None])[..., 0]

    theta0 = natural(init["q_mu"], torch.cholesky_inverse(torch.tril(init["q_sqrt"].double())))

    def change(after, s_inv):
        out = {k: (after[k].to(dev).double() - init[k].double())[mask[k]] for k in mask
               if k in init}
        out["q_sqrt"] = after["q_sqrt"].to(dev).double() - init["q_sqrt"].double()
        out["q_mu.natural"] = natural(after["q_mu"], s_inv) - theta0
        return out

    grad = svgp.leaf_gaps(g_p, g_r)
    moved = svgp.leaf_gaps(change(a_p, s_p), change(a_r, s_r))
    print(f"gaps by leaf: first gradient {grad}; change {moved}; ELBOs {e_p} against "
          f"{e_r}; backoff codes {list(c_p)} against {list(c_r)}", file=sys.stderr)
    return {"loss": svgp.worst(abs(a - b) / abs(b) for a, b in zip(e_p, e_r)),
            "grad": svgp.worst(grad.values()) if grad else math.inf,
            "change": svgp.worst(moved.values()) if moved else math.inf,
            "sinv": check.normwise(s_p, s_r),
            "backoff": 0.0 if list(c_p) == list(c_r) else math.inf}


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
            products=ng_roof.step_products(ctx.cfg), graphs=graphs,
            replayed=last.get("replayed"),
            program=dict(config=s.config, state=s.state, dataset=s.dataset,
                         batch=(s.N,) * s.T, B=s.B, rng=s.rng,
                         repeats=ctx.mix["layer_repeats"]))
        ctx.read_layers(res)
        res.layer.clear()
    s.trainer = s.state = s.dataset = None
    ctx.free()
    ctx.log("program freed; the reference")
    res.checks = check.beside(numbers(s.prog, reference(s), s.p0), ctx.limits)
    return res
