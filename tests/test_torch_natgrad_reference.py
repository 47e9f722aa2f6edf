"""The benchmark's natural-gradient reference (``hmbench/reference/
natgrad.py``) against the port's natural-gradient trainer, and the
``train_natgrad`` cell's numbers, on the CPU at a small size (Q = 2,
M = 16, three of the flagship's families, B = 32).

* one exact ``natgrad_ve_step`` of the port, float64, from a cold and
  from a carried S^{-1}, against the reference's step from its own ELBO;
* ``make_step`` over VE, VM, VE against the reference's schedule;
* the reference alone: one step at lr 1 with a Gaussian likelihood lands
  on the conjugate optimum;
* the cell run end to end on the CPU: a sound run is ``correct``; half of
  each natural-gradient batch, q left unchanged and another attempt than
  the reference's each fail it;
* the natural-gradient step's stated precision, and the cell's refusal of
  a program that forms P at another than the configuration's.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hmbench import check, inputs, port, run
from hmbench.kinds import train, train_natgrad as kind
from hmbench.reference import natgrad as ng_ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 2029
TOL = 1e-8


def _small(cfg: dict) -> dict:
    """The configuration at the tests' size."""
    return dict(cfg, num_latent=2, num_inducing=16, rows_per_task=600,
                likelihoods=cfg["likelihoods"][:3],
                train=dict(cfg["train"], batch_per_task=32))


def _cfg() -> dict:
    path = ROOT / "hmbench" / "configs" / "lmc6_natgrad_m1024.json"
    return dict(_small(json.loads(path.read_text())), dtype="float64")


def _mix() -> dict:
    mix = json.loads((ROOT / "hmbench" / "traffic" / "natgrad_calls.json").read_text())
    return dict(mix, steps_per_call=5, warm_seconds=0.2)


def _inputs(cfg):
    """prepare()'s state in float64, q_sqrt moved off the identity."""
    s = train.prepare(cfg, _mix(), SEED, "cpu")
    g = inputs.generator(SEED, "cpu", salt=1)
    s.p0 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in s.p0.items()}
    s.p0["q_sqrt"] = s.p0["q_sqrt"] + 0.05 * torch.tril(torch.randn(
        s.p0["q_sqrt"].shape, generator=g, dtype=torch.float64), -1)
    s.data = [(X.double(), Y.double()) for X, Y in s.data]
    return s


def test_one_exact_step_matches_the_port_cold_and_carried():
    cfg = _cfg()
    s = _inputs(cfg)
    config = port.model_config(cfg, "highest")
    params = port.params(s.p0)
    Luu, iLuu = elbo_mod.prior_cholesky_inverse(params, config)
    ref = ng_ref.Reference(cfg, "cpu", "float64")
    p = ref.cast(s.p0)
    S_inv = torch.cholesky_inverse(torch.tril(p["q_sqrt"]))
    steps = train.reference_steps(s)
    ve = [st for st in steps if st[0] == "ve"]
    carried = None
    for _, batch, scales in ve:  # the first cold, the second carried
        data = port.dataset(batch)
        new, elbo, aux, carried = ttrain.natgrad_ve_step(
            params, data, torch.tensor(scales, dtype=torch.float64), config,
            cfg["train"]["natgrad_lr"], Luu=Luu, iLuu=iLuu, S_inv=carried,
            retraction="exact")
        e, m, L, S_inv, code = ref.ve_step(p, S_inv, batch, scales)
        assert int(aux["ng_backoff"]) == code == 0
        assert abs(float(elbo) - e) <= 1e-10 * abs(e)
        assert check.normwise(new.q_mu, m) < TOL
        assert check.normwise(torch.tril(new.q_sqrt), L) < TOL
        assert check.normwise(carried, S_inv) < TOL
        params = new
        p = dict(p, q_mu=m, q_sqrt=L)


def test_ve_vm_ve_steps_match_the_port():
    cfg = _cfg()
    s = _inputs(cfg)
    config = port.model_config(cfg, "highest")
    tc = kind.train_config(cfg)
    step = ttrain.make_step(config, tc)
    state = port.init_state(port.params(s.p0), config, tc, _mix()["first_step"])
    elbos, calls, codes = [], [], []
    for i, (kind_, off) in enumerate(zip(s.kinds, s.offsets)):
        data = port.dataset([(X[o:o + s.B], Y[o:o + s.B])
                             for (X, Y), o in zip(s.data, off.tolist())])
        scales = torch.full((s.T,), s.N / s.B, dtype=torch.float64)
        state, metrics = step(state, data, scales)
        elbos.append(float(metrics["elbo"]))
        if kind_ == "ve":
            codes.append(int(metrics["ng_backoff"]))
        calls.append(([kind_], port.adam_moments(state)))
    grads = {k: v for k, v in check.first_grads(calls, train.free_vm(cfg["train"])).items()
             if k not in ("q_mu", "q_sqrt")}
    after = port.param_leaves(state.params)
    got = kind.numbers((elbos, grads, after, state.S_inv, codes), kind.reference(s), s.p0)
    assert got["backoff"] == 0.0
    assert max(v for k, v in got.items() if k != "backoff") < TOL, got


def test_one_step_at_lr_1_reaches_the_conjugate_optimum():
    """A Gaussian likelihood with its noise fixed: the ELBO is quadratic in
    (m, S), and one natural-gradient step at lr 1 from anywhere lands on
    S*^{-1} = I + s P^T P / sigma^2 (+ the jitter), m* = S* s P^T y /
    sigma^2 (one latent, W = 1, kappa = 0; s = N / B)."""
    sigma = 0.3
    cfg = dict(_cfg(), num_latent=1,
               likelihoods=[{"family": "Gaussian", "args": {"sigma": sigma},
                             "y": {"draw": "normal"}}])
    cfg["train"] = dict(cfg["train"], natgrad_lr=1.0)
    s = _inputs(cfg)
    s.p0["W"] = torch.ones_like(s.p0["W"])
    ref = ng_ref.Reference(cfg, "cpu", "float64")
    p = ref.cast(s.p0)
    _, batch, scales = train.reference_steps(s)[0]
    (X, Y), scale = batch[0], scales[0]
    _, iL = ref.factor(p)
    P = ref.kern(X, p["Z"], torch.exp(p["log_lengthscale"]),
                 torch.exp(p["log_variance"])) @ iL.mT  # (1, B, M)
    eye = torch.eye(cfg["num_inducing"], dtype=torch.float64)
    prec = eye + scale * P.mT @ P / sigma ** 2 + cfg["jitter"] * eye
    m_opt = torch.linalg.solve(prec, scale * P.mT @ Y[None] / sigma ** 2)[..., 0]
    S_inv = torch.cholesky_inverse(torch.tril(p["q_sqrt"]))
    _, m, L, S_inv_new, code = ref.ve_step(p, S_inv, batch, scales)
    assert code == 0
    assert check.normwise(S_inv_new, prec) < 1e-12
    assert check.normwise(m, m_opt) < 1e-9
    assert check.normwise(L @ L.mT, torch.linalg.inv(prec)) < 1e-9


def _tiny_root(dest: Path) -> Path:
    """BENCHMARK.json and hmbench/ under ``dest``, the natural-gradient
    configuration and mix at the tests' size."""
    shutil.copytree(ROOT / "hmbench", dest / "hmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    cfg_path = dest / "hmbench" / "configs" / "lmc6_natgrad_m1024.json"
    cfg_path.write_text(json.dumps(_small(json.loads(cfg_path.read_text()))))
    (dest / "hmbench" / "traffic" / "natgrad_calls.json").write_text(json.dumps(_mix()))
    return dest


def _attempt_moves(root: Path) -> tuple:
    """The whitened mean's largest move of the reference's first checked
    step at natgrad_lr and at natgrad_lr / 4."""
    cfg = json.loads((root / "hmbench" / "configs" / "lmc6_natgrad_m1024.json").read_text())
    s = train.prepare(cfg, _mix(), SEED, "cpu")
    ref = ng_ref.Reference(cfg, "cpu", "float64")
    p = ref.cast(s.p0)
    S_inv = torch.cholesky_inverse(torch.tril(p["q_sqrt"]))
    _, batch, scales = train.reference_steps(s)[0]
    moves = []
    for lr in (ref.ng_lr, 0.25 * ref.ng_lr):
        ref.ng_lr = lr
        moves.append(float((ref.ve_step(p, S_inv, batch, scales)[1] - p["q_mu"]).abs().max()))
    return tuple(moves)


def _half_batch(monkeypatch, root):
    step = ttrain.natgrad_ve_step

    def half(params, data, scales, *a, **kw):
        data = tuple(elbo_mod.TaskData(*(x[:max(1, x.shape[0] // 2)] for x in td))
                     for td in data)
        return step(params, data, 2.0 * scales, *a, **kw)

    monkeypatch.setattr(ttrain, "natgrad_ve_step", half)


def _q_unchanged(monkeypatch, root):
    monkeypatch.setattr(ttrain, "_NG_STEP_MAX", 0.0)  # both attempts rejected


def _another_attempt(monkeypatch, root):
    at_lr, at_quarter = _attempt_moves(root)
    assert at_quarter < at_lr
    # the step at natgrad_lr rejected, the one at natgrad_lr / 4 taken
    monkeypatch.setattr(ttrain, "_NG_STEP_MAX", math.sqrt(at_lr * at_quarter))


@pytest.mark.parametrize("fault, fails", [
    (None, None), (_half_batch, "sinv"), (_q_unchanged, "backoff"),
    (_another_attempt, "backoff")],
    ids=["sound", "half_batch", "q_unchanged", "another_attempt"])
def test_the_cell_is_correct_and_each_fault_fails_it(tmp_path, monkeypatch, fault, fails):
    root = _tiny_root(tmp_path)
    if fault is not None:
        fault(monkeypatch, root)
    out = run.execute("lmc6-natgrad", SEED, 0.3, False, device="cpu", root=root)
    assert set(out["checks"]) == {"loss", "grad", "change", "sinv", "backoff"}
    assert out["failed"] == 0 and out["attempted"] > 0
    if fault is None:
        assert out["correct"], out["checks"]
    else:
        assert not out["correct"]
        c = out["checks"][fails]
        assert not c["value"] <= c["limit"], out["checks"]


@pytest.mark.parametrize("retraction, ve_fwd, expected", [
    ("exact", "high", "highest"), ("exact", "highest", "highest"),
    ("cholesky", "high", "high"), ("cholesky", "highest", "highest")])
def test_the_natural_gradient_step_states_its_precision(retraction, ve_fwd, expected):
    cfg = _cfg()
    config = port.model_config(cfg, ve_fwd)
    assert ttrain.natgrad_precision(config, retraction) == expected


@pytest.mark.parametrize("program", ["another_precision", "silent"])
def test_the_cell_refuses_a_program_that_runs_it_otherwise(tmp_path, monkeypatch, program):
    root = _tiny_root(tmp_path)
    if program == "silent":  # a program that cannot say what its step runs at
        monkeypatch.delattr(ttrain, "natgrad_precision")
    else:  # P at the config's "high" under the exact retraction
        monkeypatch.setattr(ttrain, "natgrad_precision",
                            lambda config, retraction: config.projection_precision)
    with pytest.raises(SystemExit, match="does not run this configuration"):
        run.execute("lmc6-natgrad", SEED, 0.3, False, device="cpu", root=root)
