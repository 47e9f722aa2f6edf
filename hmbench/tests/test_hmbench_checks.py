"""What decides ``correct``: a sound run passes, and a run with its timed
path broken underneath fails, once for each fault a cell can have (a step
that returns its state unchanged; half of each batch left out, the mean
taken over the rest; an answer altered where it is produced; half of each
answer's rows left out).  Runs on the CPU at a tiny size, the program
taking its plain paths; the harness's look for a card is skipped.

The control, the reference computed in TF32 in the program's place, fails
the cell's limits at the cell's own size (the float64 reference beside it;
on the CPU, TF32 rounding emulated as the card's tensor cores round)."""

from __future__ import annotations

import json

import pytest
import torch

import hetmogp_tpu_torch as tp
from conftest import ROOT
from hmbench import check, run
from hmbench.kinds import train
from hmbench.reference import svgp
from hetmogp_tpu_torch import train as port_train
from hetmogp_tpu_torch.models import elbo as elbo_mod

SEED = 2 ** 31 + 4321


def _run(root, cell):
    return run.execute(cell, SEED, 0.3, False, device="cpu", root=root)


@pytest.mark.parametrize("cell", ["lmc6-train", "fam10-train", "lmc6-serve"])
def test_a_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", ["lmc6-train", "fam10-train"])
def test_a_step_that_leaves_the_state_unchanged_fails(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(port_train, "_assign", lambda dst, src: None)
    assert not _run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("cell", ["lmc6-train", "fam10-train"])
def test_half_of_each_batch_left_out_fails(tiny_root, cell, monkeypatch):
    elbo_fn = elbo_mod.elbo_fn

    def half(params, data, scales, config, *a, **kw):
        data = tuple(elbo_mod.TaskData(*(x[:max(1, x.shape[0] // 2)] for x in td))
                     for td in data)
        return elbo_fn(params, data, 2.0 * scales, config, *a, **kw)

    monkeypatch.setattr(elbo_mod, "elbo_fn", half)
    assert not _run(tiny_root, cell)["correct"]


def _serving_fault(monkeypatch, fault):
    make = tp.make_serving_predictive

    def broken(*a, **kw):
        fn = make(*a, **kw)

        def serve(X):
            return tuple(fault(t) for t in fn(X))
        return serve

    monkeypatch.setattr(tp, "make_serving_predictive", broken)


def _altered(t):
    t = t.clone()
    flat = t.view(-1)
    i = int(flat.abs().argmax())
    flat[i] = 1.5 * flat[i]
    return t


def _halved(t):
    t = t.clone()
    t[t.shape[0] // 2:] = 0.0
    return t


@pytest.mark.parametrize("fault", [_altered, _halved])
def test_a_wrong_answer_fails(tiny_root, monkeypatch, fault):
    _serving_fault(monkeypatch, fault)
    assert not _run(tiny_root, "lmc6-serve")["correct"]


def _limits(cell):
    d = json.loads((ROOT / "hmbench" / "limits" / f"{cell}.json").read_text())
    return {k: v["limit"] for k, v in d.items()}


@pytest.mark.parametrize("cell,name", [("lmc6-train", "lmc6_m1024"),
                                       ("fam10-train", "fam10_m1024")])
def test_the_control_fails_at_the_cells_size(cell, name):
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    cfg = json.loads((ROOT / "hmbench" / "configs" / f"{name}.json").read_text())
    mix = json.loads((ROOT / "hmbench" / "traffic" / "train_calls.json").read_text())
    s = train.prepare(cfg, mix, SEED, "cpu")
    ref = train.reference(s)
    sound = check.beside(check.train_numbers(ref, ref, s.p0), _limits(cell))
    control = check.beside(check.train_numbers(train.reference(s, "tf32"), ref, s.p0),
                           _limits(cell))
    assert check.passed(sound) and not check.passed(control), control


def test_the_serving_control_fails_at_the_cells_size():
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    cfg = json.loads((ROOT / "hmbench" / "configs" / "lmc6_m1024.json").read_text())
    from hmbench import inputs
    g = inputs.generator(SEED, "cpu")
    p0 = inputs.init_params(cfg, g, "cpu", serving=True)
    X = torch.rand((4096, 2), generator=g)
    ref, ref32 = (svgp.Reference(cfg, "cpu", p) for p in ("float64", "tf32"))
    kept = [(t, X, *ref32.served(p0, X, t)) for t in range(len(cfg["likelihoods"]))]
    control = check.beside(check.serve_numbers(ref, p0, kept), _limits("lmc6-serve"))
    assert not check.passed(control), control


def test_first_gradients_are_read_from_the_state_after_each_checked_call():
    b1, g = svgp.B1, {"q_mu": torch.tensor([2.0, -1.0]), "Z": torch.tensor([0.5])}
    after_ve = {"q_mu": (1 - b1) * g["q_mu"], "Z": torch.zeros(1)}
    # a VM step, then a VE step in the same call: Z's moment decays once
    after_vm_ve = {"q_mu": b1 * after_ve["q_mu"] + (1 - b1) * 7.0,
                   "Z": b1 * (1 - b1) * g["Z"]}
    got = check.first_grads([(["ve"], after_ve), (["vm", "ve"], after_vm_ve)], ("Z",))
    assert set(got) == {"q_mu", "Z"}
    assert all(torch.allclose(got[k], g[k].double()) for k in g)
    with pytest.raises(ValueError, match="free twice"):
        check.first_grads([(["ve", "ve"], after_ve)], ("Z",))


def test_the_change_is_taken_over_the_elements_the_gradient_resolves():
    g_r = {"a": torch.tensor([1.0, 1e-9, -2.0]), "b": torch.tensor([1e-9, 1e-9])}
    g_p = {"a": torch.tensor([1.1, 3e-9, -2.1]), "b": torch.tensor([4e-9, -3e-9])}
    mask = check.resolved(g_p, g_r)
    assert mask["a"].tolist() == [True, False, True]
    assert mask["b"].tolist() == [True, True]  # none resolved: the whole leaf
    # a step that returns its state unchanged (no moment, no change) reads 1
    p0 = {"a": torch.zeros(3), "b": torch.zeros(2)}
    ref = ([1.0], g_r, {"a": torch.tensor([-1.0, 1.0, 1.0]), "b": torch.ones(2)})
    prog = ([1.0], {k: torch.zeros_like(v) for k, v in g_r.items()}, p0)
    assert check.train_numbers(prog, ref, p0)["change"] == pytest.approx(1.0)
