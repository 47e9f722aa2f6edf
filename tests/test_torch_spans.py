"""The port's spans (``profiling.annotate``, ``spans``, ``span_report``):
off, they record nothing; under a profiler session the eager steps and the
served requests record their layers' spans, nested and grouped; the
report's arithmetic on hand-made records; the benchmark's six readers of
the spans on a synthetic report; and, on a card only (marked ``card``), the
graphed trainer's stamps and node counters."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import profiling
from hetmogp_tpu_torch import train as ttrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEP = ["step", "elbo.projections", "elbo.likelihood", "backward.likelihood",
        "backward.projections"]


@pytest.fixture(autouse=True)
def fresh_record(monkeypatch):
    """Each test starts with no session's record."""
    monkeypatch.setattr(profiling, "_record", None)


def _model(device="cpu", m=8, dtype="float64"):
    rng = np.random.default_rng(0)
    cfg = tp.ModelConfig(likelihoods=(tp.HetGaussian(), tp.Bernoulli()),
                         num_latent=2, num_inducing=m, input_dim=1,
                         dtype=dtype, jitter=1e-4, adaptive_jitter=False)
    params = tp.init_params(rng, cfg, np.linspace(0, 1, m)[:, None],
                            device=device)
    X = [rng.random((40, 1)), rng.random((30, 1))]
    Y = [rng.standard_normal((40, 1)),
         (rng.random((30, 1)) > 0.5).astype(float)]
    return cfg, params, tp.make_dataset(X, Y, cfg, device=device)


def _by_group(rep):
    out = {}
    for i, o in enumerate(rep["occurrences"]):
        out.setdefault(o["group"], []).append((i, o))
    return out


def test_spans_off_record_nothing():
    assert profiling.annotate("x") is profiling.annotate("y")
    with profiling.annotate("x"):
        pass
    cfg, params, ds = _model()
    tc = tp.TrainConfig(ve_steps_per_vm=1)
    step = ttrain.make_step(cfg, tc)
    step(tp.init_train_state(params, cfg, tc), ds,
         torch.ones(2, dtype=torch.float64))
    assert profiling.annotate("z") is profiling.annotate("y")
    assert profiling.span_report() == {}


def test_a_ve_and_a_vm_step_record_their_layers(tmp_path):
    cfg, params, ds = _model()
    tc = tp.TrainConfig(ve_steps_per_vm=1)
    step = ttrain.make_step(cfg, tc)
    state = tp.init_train_state(params, cfg, tc)
    scales = torch.ones(2, dtype=torch.float64)
    with profiling.trace(str(tmp_path)):
        assert profiling.annotate("x") is not profiling.annotate("y")
        state, _ = step(state, ds, scales)  # step 0: VE
        state, _ = step(state, ds, scales)  # step 1: VM
    assert profiling.annotate("x") is profiling.annotate("y")
    rep = profiling.span_report()
    assert rep["source"] == "host" and rep["steps"] == 2
    groups = _by_group(rep)
    assert len(groups) == 2
    for g, want in zip(sorted(groups), (STEP, STEP + ["refresh"])):
        spans = groups[g]
        assert [o["name"] for _, o in spans] == want
        (top, step_span), *inner = spans
        assert step_span["parent"] is None
        assert all(o["parent"] == top for _, o in inner)
        for _, o in inner:
            assert (step_span["host_start_ns"] <= o["host_start_ns"]
                    <= o["host_end_ns"] <= step_span["host_end_ns"])
        for (_, a), (_, b) in zip(inner, inner[1:]):
            assert a["host_end_ns"] <= b["host_start_ns"]
    assert rep["spans"]["refresh"]["count"] == 1
    assert rep["spans"]["step"]["count"] == 2
    written = json.loads(next(tmp_path.glob("spans_*.json")).read_text())
    assert written["spans"].keys() == rep["spans"].keys()


def test_an_eager_trainer_call_numbers_its_steps():
    cfg, params, ds = _model()
    tc = tp.TrainConfig(ve_steps_per_vm=2, minibatch="slice")
    run = tp.make_scan_trainer(cfg, tc, (40, 30), (16, 16), steps_per_call=3,
                               device="cpu")
    state = tp.init_train_state(params, cfg, tc)
    offsets = torch.zeros((3, 2), dtype=torch.int64)
    with profiling.spans():
        state, _ = run(state, ds, offsets=offsets)
        state, _ = run(state, ds, offsets=offsets)
    rep = profiling.span_report()
    steps = [g for g in rep["groups"] if g["name"] == "step"]
    assert [(g["call"], g["index"]) for g in steps] == [
        (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)]
    # the third step of each call is the schedule's VM step
    assert rep["spans"]["refresh"]["count"] == 2


def test_a_served_request_records_its_spans():
    cfg, params, _ = _model()
    serve = tp.make_serving_predictive(params, cfg, 1)
    X = torch.rand(25, 1, dtype=torch.float64)
    with profiling.spans():
        serve(X)
        serve(X[:10])
    rep = profiling.span_report()
    groups = _by_group(rep)
    assert [g["name"] for g in rep["groups"]] == ["serve.request"] * 2
    for spans in groups.values():
        assert [o["name"] for _, o in spans] == [
            "serve.request", "predict.moments", "predict.likelihood"]
        assert [o["parent"] for _, o in spans[1:]] == [spans[0][0]] * 2


NATGRAD = ["step", "natgrad.moments", "natgrad.likelihood",
           "natgrad.contractions", "natgrad.retraction"]


@pytest.mark.parametrize("retraction, factored", [("exact", 2),
                                                  ("cholesky", 0)])
def test_a_natgrad_ve_step_records_its_spans_and_counters(retraction,
                                                          factored):
    """A natural-gradient VE step's layers nest under ``step``, the exact
    retraction's one ``natgrad.factor`` (both attempts' A in one call)
    under ``natgrad.retraction``, and the counters of its attempts and its
    factorization calls go to the retraction; the VM step after it
    records the adam trainer's layers."""
    cfg, params, ds = _model()
    tc = tp.TrainConfig(optimizer="natgrad_adam", ve_steps_per_vm=1,
                        natgrad_retraction=retraction)
    step = ttrain.make_step(cfg, tc)
    state = tp.init_train_state(params, cfg, tc)
    scales = torch.ones(2, dtype=torch.float64)
    with profiling.spans():
        state, _ = step(state, ds, scales)  # step 0: VE
        state, _ = step(state, ds, scales)  # step 1: VM
    rep = profiling.span_report()
    calls = min(factored, 1)
    ve, vm = (spans for _, spans in sorted(_by_group(rep).items()))
    assert [o["name"] for _, o in ve] == NATGRAD + ["natgrad.factor"] * calls
    (top, _), *inner = ve
    at = {o["name"]: i for i, o in ve}
    for _, o in inner:
        want = (at["natgrad.retraction"] if o["name"] == "natgrad.factor"
                else top)
        assert o["parent"] == want, o["name"]
    for (_, a), (_, b) in zip(inner[:4], inner[1:4]):
        assert a["host_end_ns"] <= b["host_start_ns"]
    assert [o["name"] for _, o in vm] == STEP + ["refresh"]
    assert rep["spans"]["natgrad.retraction"]["counts"] == {
        "natgrad.attempts": 2, "natgrad.factorizations": calls}
    assert rep["spans"]["step"]["counts"] == {}
    # the likelihood term's own counters open inside natgrad.likelihood
    assert set(rep["spans"]["natgrad.likelihood"]["counts"]) == {
        "likelihood.table_tasks", "likelihood.engine_tasks"}


MS = 1_000_000  # ns


def _record(monkeypatch, spans, stamps, clock):
    """A hand-made record: ``spans`` (name, parent, host start, host end,
    start slot, end slot), the eager ring's ``stamps`` {slot: ns}."""
    rec = profiling._Record()
    for name, parent, h0, h1, s0, s1 in spans:
        p = None if parent is None else rec.spans[parent]
        o = profiling._Occurrence(name, p, rec._group(name) if p is None
                                  else p.group)
        o.host_start, o.host_end, o.start_slot, o.end_slot = h0, h1, s0, s1
        rec.spans.append(o)
    ring = torch.full((profiling.EAGER_SLOTS,), -1, dtype=torch.int64)
    for slot, ns in stamps.items():
        ring[slot] = ns
    rec.ring, rec.slots, rec.clock, rec.closed = ring, len(stamps), clock, True
    monkeypatch.setattr(profiling, "_record", rec)
    monkeypatch.setattr(profiling, "_calibrate", lambda device: dict(
        clock, offset_ns=clock["offset_ns"] + 5))
    return rec


CLOCK = {"offset_ns": 1000 * MS, "uncertainty_ns": 2000.0,
         "resolution_ns": 32, "samples": 64, "consistent": True}


def test_the_report_takes_self_time_and_gaps_from_the_stamps(monkeypatch):
    # two requests: r0 [0, 10] ms with children [1, 4] and [3, 6] (which
    # overlap) and [8, 9]; r1 [12, 20] with one child [13, 19].  The host
    # entered r1 at 1011.5 ms: the device went idle at 10 (1010 on the
    # host's clock), so the host held it 1.5 ms, in no program span
    spans = [("serve.request", None, 1000 * MS, 1009 * MS, 0, 1),
             ("a", 0, 1000 * MS, 1001 * MS, 2, 3),
             ("b", 0, 1001 * MS, 1002 * MS, 4, 5),
             ("a", 0, 1002 * MS, 1003 * MS, 6, 7),
             ("serve.request", None, 1011.5 * MS, 1015 * MS, 8, 9),
             ("b", 4, 1012 * MS, 1013 * MS, 10, 11)]
    stamps = {0: 0, 1: 10 * MS, 2: 1 * MS, 3: 4 * MS, 4: 3 * MS, 5: 6 * MS,
              6: 8 * MS, 7: 9 * MS, 8: 12 * MS, 9: 20 * MS, 10: 13 * MS,
              11: 19 * MS}
    _record(monkeypatch, spans, stamps, CLOCK)
    rep = profiling.span_report()
    assert rep["source"] == "device" and rep["steps"] == 0
    s = rep["spans"]
    assert s["serve.request"]["count"] == 2
    assert s["serve.request"]["wall_ms"] == pytest.approx(18.0)
    # r0: 10 - |[1, 6] u [8, 9]| = 4; r1: 8 - 6 = 2
    assert s["serve.request"]["self_ms"] == pytest.approx(6.0)
    assert s["serve.request"]["self_ms_mean"] == pytest.approx(3.0)
    assert s["a"]["wall_ms"] == pytest.approx(4.0)
    assert s["b"]["wall_ms_mean"] == pytest.approx(4.5)
    (gap,) = rep["gaps"]
    assert (gap["after"], gap["before"]) == (0, 1)
    assert gap["us"] == pytest.approx(2000.0)
    assert gap["to"] == "caller" and gap["held_by"] == "host"
    assert gap["host_late_us"] == pytest.approx(1500.0)
    assert rep["clock"]["drift_ns"] == 5


def test_a_gap_goes_to_the_open_span_or_to_the_device(monkeypatch):
    # r1 was launched (host 1009.0) while a span "caller.work", a
    # top-level span of its own, was open, and before the device went idle
    # (10 ms: host 1010): the device held it
    spans = [("serve.request", None, 1000 * MS, 1001 * MS, 0, 1),
             ("caller.work", None, 1008.5 * MS, 1010 * MS, None, None),
             ("serve.request", None, 1009 * MS, 1010 * MS, 2, 3)]
    stamps = {0: 0, 1: 10 * MS, 2: 10.5 * MS, 3: 11 * MS}
    _record(monkeypatch, spans, stamps, CLOCK)
    (gap,) = profiling.span_report()["gaps"]
    assert gap["us"] == pytest.approx(500.0)
    assert gap["to"] == "caller.work"
    assert gap["host_late_us"] == pytest.approx(-1000.0)
    assert gap["held_by"] == "device"


ROWS = {"ve": [("step", None, 0, 1000), ("elbo.projections", 0, 100, 500),
               ("elbo.likelihood", 0, 500, 600)]}
ROWS["vm"] = ROWS["ve"] + [("refresh", 0, 600, 900)]


def _replayed(monkeypatch, steps=4, vm_every=2, gap_ns=7000, rows=None,
              counts=None):
    """A record of one trainer call of ``steps`` replays: ``rows`` {kind:
    [(span, parent, start us, end us)]}, by default VE steps of 1 ms with
    children projections [0.1, 0.5], likelihood [0.5, 0.6], and VM steps
    with a refresh [0.6, 0.9] too; ``gap_ns`` between steps; ``counts``
    {(kind, span): program counters} of the plans' spans."""
    S = profiling.STAMPS_PER_STEP
    rows = rows or ROWS
    counts = counts or {}

    def plan(kind):
        out = []
        for k, (name, parent, _, _) in enumerate(rows[kind]):
            s = profiling._PlanSpan(name, parent)
            s.start, s.end = 2 * k, 2 * k + 1
            s.nodes = {"hand": 2, "stamps": 0,
                       "library": 10 + k + 5 * (kind == "vm"),
                       "memory": 1, "other": 0}
            s.launches = {}
            s.counts = dict(counts.get((kind, name), {}))
            out.append(s)
        return out

    plans = {"ve": plan("ve"), "vm": plan("vm")}
    ring = torch.full((steps * S,), -1, dtype=torch.int64)
    run = profiling._Run(1, plans, ring)
    t, host = 0, 0
    for j in range(steps):
        kind = "vm" if j % vm_every == vm_every - 1 else "ve"
        run.kinds.append(kind)
        run.launched.append(host)
        for k, (_, _, a, b) in enumerate(rows[kind]):
            ring[j * S + 2 * k] = t + a * 1000
            ring[j * S + 2 * k + 1] = t + b * 1000
        t += 1000 * 1000 + gap_ns
    run.rows.append(ring.clone())
    rec = profiling._Record()
    rec.runs.append(run)
    rec.calls, rec.clock, rec.closed = 1, None, True
    monkeypatch.setattr(profiling, "_record", rec)
    return rec


def test_a_replayed_call_expands_to_its_steps(monkeypatch):
    _replayed(monkeypatch)
    rep = profiling.span_report()
    assert rep["steps"] == 4
    assert [(g["call"], g["index"], g["kind"]) for g in rep["groups"]] == [
        (1, 0, "ve"), (1, 1, "vm"), (1, 2, "ve"), (1, 3, "vm")]
    s = rep["spans"]
    assert s["step"]["wall_ms_mean"] == pytest.approx(1.0)
    assert s["step"]["self_ms"] == pytest.approx(4 * 0.5 - 2 * 0.3)
    assert s["refresh"]["count"] == 2
    assert s["refresh"]["wall_ms_mean"] == pytest.approx(0.3)
    assert [g["us"] for g in rep["gaps"]] == pytest.approx([7.0] * 3)
    assert all(g["to"] == "caller" and g["held_by"] is None
               for g in rep["gaps"])


def test_program_counters_go_to_the_open_span_and_to_its_replays(
        monkeypatch):
    """``profiling.count``: spans off or outside a span, nothing; at a
    capture, into the open span of the graph's plan (``_tally``, so
    ``graph_counters()``, by graph kind and span); a replayed step's
    occurrences carry their plan's, which ``span_report`` sums by span."""
    profiling.count("likelihood.table_tasks", 4)  # spans off: nothing
    cap = profiling._Capture()
    cap.count("likelihood.table_tasks", 4)  # no open span: nothing
    rec = _replayed(monkeypatch)
    for plan in rec.runs[0].plans.values():
        cap.stack = [plan[0], plan[2]]  # step, then elbo.likelihood
        cap.count("likelihood.table_tasks", 4)
        cap.count("likelihood.engine_tasks", 6)
    want = {"likelihood.table_tasks": 4, "likelihood.engine_tasks": 6}
    for plan in rec.runs[0].plans.values():
        tally = profiling._tally(plan)
        assert tally["elbo.likelihood"]["counts"] == want
        assert tally["step"]["counts"] == {}
    rep = profiling.span_report()
    assert rep["spans"]["elbo.likelihood"]["counts"] == {
        k: 4 * v for k, v in want.items()}  # four replayed steps
    assert rep["spans"]["step"]["counts"] == {}


def _reader(name):
    path = ROOT / "hmbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TRAIN_LAYER = {"kind": "train", "replayed": {"ve": 2, "vm": 2},
               "cycle": {"ve": 4, "vm": 1}}


@pytest.mark.parametrize("name, want", [
    ("elbo.projections_ms.train", 0.4),
    ("likelihood.step_ms.train", 0.1),
    ("refresh.step_ms.train", 0.3),
    ("loop.replay_gap_us.train", 7.0),
    ("step.library_kernels.train", 11.0),  # (4 * 10 + 15) / 5
])
def test_each_train_reader_reads_the_spans(monkeypatch, name, want):
    _replayed(monkeypatch)
    rep = profiling.span_report()
    rep["counters"] = {k: profiling._tally(p) for k, p in
                       profiling._record.runs[0].plans.items()}
    monkeypatch.setattr(profiling, "span_report", lambda: rep)
    read = _reader(name)
    assert read(dict(TRAIN_LAYER)) == pytest.approx(want)
    # another number of steps than the traced call replayed; another kind
    assert read(dict(TRAIN_LAYER, replayed={"ve": 3, "vm": 2})) is None
    assert read(dict(TRAIN_LAYER, kind="serve")) is None
    monkeypatch.setattr(profiling, "span_report", lambda: {})
    assert read(dict(TRAIN_LAYER)) is None


NATGRAD_ROWS = {
    "ve": [("step", None, 0, 1000), ("natgrad.moments", 0, 0, 100),
           ("natgrad.likelihood", 0, 100, 200),
           ("natgrad.contractions", 0, 200, 400),
           ("natgrad.retraction", 0, 400, 1000),
           ("natgrad.factor", 4, 450, 600), ("natgrad.factor", 4, 700, 850)],
    "vm": ROWS["vm"]}


@pytest.mark.parametrize("name, want", [
    ("natgrad.contractions_ms.train", 0.2),  # a VE step's
    ("natgrad.factor_ms.train", 0.15),  # a factorization's
])
def test_each_natgrad_reader_reads_the_spans(monkeypatch, name, want):
    counted = {("ve", "natgrad.retraction"): {"natgrad.attempts": 2,
                                              "natgrad.factorizations": 2}}
    read = _reader(name)
    _replayed(monkeypatch, rows=NATGRAD_ROWS, counts=counted)
    assert read(dict(TRAIN_LAYER)) == pytest.approx(want)
    assert read(dict(TRAIN_LAYER, replayed={"ve": 3, "vm": 2})) is None
    assert read(dict(TRAIN_LAYER, kind="serve")) is None
    # the adam trainer's call, or a program whose step opens no natgrad
    # span (an earlier one's): nothing to read
    _replayed(monkeypatch)
    assert read(dict(TRAIN_LAYER)) is None
    monkeypatch.setattr(profiling, "span_report", lambda: {})
    assert read(dict(TRAIN_LAYER)) is None


def test_the_factor_reader_needs_the_factorizations_counted(monkeypatch):
    _replayed(monkeypatch, rows=NATGRAD_ROWS)
    assert _reader("natgrad.factor_ms.train")(dict(TRAIN_LAYER)) is None


def test_one_call_factoring_both_attempts_reads_per_call(monkeypatch):
    """The exact step's one ``natgrad.factor`` a VE step over both
    attempts' A: ``natgrad.factor_ms.train`` reads the call; a count that
    disagrees with the spans timed leaves it unread."""
    rows = dict(NATGRAD_ROWS, ve=NATGRAD_ROWS["ve"][:-1])
    read = _reader("natgrad.factor_ms.train")
    for calls, want in ((1, 0.15), (2, None)):
        counts = {"natgrad.attempts": 2, "natgrad.factorizations": calls}
        _replayed(monkeypatch, rows=rows,
                  counts={("ve", "natgrad.retraction"): counts})
        got = read(dict(TRAIN_LAYER))
        assert got == (pytest.approx(want) if want else None)


def test_the_serving_reader_takes_the_median_gap(monkeypatch):
    # three requests of 1 ms, 2 ms and 5 ms apart on the device
    spans, stamps, t = [], {}, 0
    for i, gap in enumerate((2, 5, 0)):
        spans.append(("serve.request", None, 1000 * MS + t, 1000 * MS + t
                      + MS, 2 * i, 2 * i + 1))
        stamps[2 * i], stamps[2 * i + 1] = t, t + MS
        t += MS + gap * MS
    _record(monkeypatch, spans, stamps, CLOCK)
    read = _reader("serve.request_gap_us")
    assert read({"kind": "serve"}) == pytest.approx(3500.0)
    assert read({"kind": "train"}) is None
    monkeypatch.setattr(profiling, "span_report", lambda: {})
    assert read({"kind": "serve"}) is None


@pytest.mark.card
def test_graphed_stamps_are_off_until_spans_are_on():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    cfg, params, ds = _model("cuda", m=16, dtype="float32")
    tc = tp.TrainConfig(ve_steps_per_vm=2, minibatch="slice")
    run = tp.make_scan_trainer(cfg, tc, (40, 30), (16, 16), steps_per_call=6)
    state = tp.init_train_state(params, cfg, tc)
    offsets = torch.zeros((6, 2), dtype=torch.int64)
    state, _ = run(state, ds, offsets=offsets)  # captures, spans off
    torch.cuda.synchronize()
    assert bool((run.stamp_ring == -1).all())
    with profiling.spans():
        state, _ = run(state, ds, offsets=offsets)
        torch.cuda.synchronize()
        ring = run.stamp_ring.view(6, profiling.STAMPS_PER_STEP).cpu()
    for j, kind in enumerate(run.step_kinds):
        want = 2 * len(run.span_plans[kind])  # every span stamped twice
        assert bool((ring[j, :want] > 0).all())
        assert bool((ring[j, want:] == -1).all())
    kept = run.stamp_ring.clone()
    state, _ = run(state, ds, offsets=offsets)  # spans off again
    torch.cuda.synchronize()
    assert torch.equal(run.stamp_ring, kept)
    rep = profiling.span_report()
    assert rep["source"] == "device" and rep["steps"] == 6
    assert rep["clock"]["uncertainty_ns"] <= 10_000
    counters = profiling.graph_counters()
    for kind, launched in run.capture_launches.items():
        step = counters[kind]["step"]
        assert step["launches"] == {k: v for k, v in launched.items() if v}
        assert step["hand"] >= sum(v for k, v in launched.items()
                                   if k != "rbf_backward")
        assert step["stamps"] == 0  # the replayed graphs hold none


@pytest.mark.card
@pytest.mark.parametrize("retraction, factored", [("exact", 2),
                                                  ("cholesky", 0)])
def test_graphed_natgrad_steps_count_their_spans(retraction, factored):
    """The natural-gradient VE graph's capture counts its attempts and its
    factorization calls (one for both attempts' A: one launch of kernel 9
    at M = 16) in ``natgrad.retraction`` (``graph_counters()``), and a
    call under ``spans()`` stamps every natgrad span of every VE step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    cfg, params, ds = _model("cuda", m=16, dtype="float32")
    tc = tp.TrainConfig(optimizer="natgrad_adam", ve_steps_per_vm=2,
                        natgrad_retraction=retraction, minibatch="slice")
    run = tp.make_scan_trainer(cfg, tc, (40, 30), (16, 16), steps_per_call=6)
    state = tp.init_train_state(params, cfg, tc)
    offsets = torch.zeros((6, 2), dtype=torch.int64)
    state, _ = run(state, ds, offsets=offsets)  # captures, spans off
    counters = profiling.graph_counters()
    calls = min(factored, 1)
    want = {"natgrad.attempts": 2, "natgrad.factorizations": calls}
    assert counters["ve"]["natgrad.retraction"]["counts"] == want
    assert ("natgrad.factor" in counters["ve"]) == (calls > 0)
    assert not any(k.startswith("natgrad.") for k in counters["vm"])
    if calls:
        assert counters["ve"]["natgrad.factor"]["launches"]["chol_panel"] \
            == calls
    with profiling.spans():
        state, _ = run(state, ds, offsets=offsets)
    rep = profiling.span_report()
    n_ve = run.step_kinds.count("ve")
    assert rep["source"] == "device" and n_ve == 4
    assert rep["spans"]["natgrad.retraction"]["counts"] == {
        k: n_ve * v for k, v in want.items()}
    for name in NATGRAD[1:]:
        assert rep["spans"][name]["timed"] == n_ve, name
    assert rep["spans"].get("natgrad.factor", {}).get("timed", 0) \
        == calls * n_ve
