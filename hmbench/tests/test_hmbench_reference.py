"""The plain reference agrees with the program's plain path (CPU tensors
take the plain PyTorch versions of its kernels) in float64 at a tiny size,
for both configurations: the ELBO, its gradient for every leaf, and the
served moments."""

from __future__ import annotations

import json

import pytest
import torch

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch.models.params import from_leaves
from conftest import ROOT
from hmbench import inputs, port
from hmbench.reference import svgp


def _setup(name, seed):
    cfg = json.loads((ROOT / "hmbench" / "configs" / f"{name}.json").read_text())
    cfg = dict(cfg, num_inducing=12, rows_per_task=40, dtype="float64")
    g = inputs.generator(seed, "cpu")
    p0 = {k: (v.double() if torch.is_tensor(v) else v and [t.double() for t in v])
          for k, v in inputs.init_params(cfg, g, "cpu").items()}
    p0["q_sqrt"] = p0["q_sqrt"] + 0.05 * torch.tril(torch.randn(
        p0["q_sqrt"].shape, generator=g, dtype=torch.float64), -1)
    data = [(x.double(), y.double()) for x, y in inputs.task_data(cfg, g, "cpu")]
    return cfg, p0, data


@pytest.mark.parametrize("name", ["lmc6_m1024", "fam10_m1024"])
def test_elbo_and_its_gradient_match_the_program(name):
    cfg, p0, data = _setup(name, 2 ** 31 + 3)
    config = port.model_config(cfg, "highest")
    scales = torch.tensor([3.0] * len(data), dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in port.param_leaves(port.params(p0)).values()]
    prm = from_leaves(port.params(p0), leaves)
    elbo, _ = tp.elbo_fn(prm, port.dataset(data), scales, config)
    want_g = torch.autograd.grad(elbo, [t for t in leaves if t.numel()])

    ref = svgp.Reference(cfg, "cpu", "float64")
    q = ref.cast(p0)
    names = list(svgp.LEAVES) + [f"lik_theta.{t}" for t in range(len(ref.liks))]

    def leaf(n):
        return q["lik_theta"][int(n[10:])] if n.startswith("lik_theta.") else q[n]

    live = [n for n in names if leaf(n).numel()]
    for n in live:
        t = leaf(n).clone().requires_grad_()
        if n.startswith("lik_theta."):
            q["lik_theta"][int(n[10:])] = t
        else:
            q[n] = t
    got = ref.elbo(q, data, [3.0] * len(data))
    got_g = torch.autograd.grad(got, [leaf(n) for n in live])
    assert float(got.detach()) == pytest.approx(float(elbo.detach()), rel=1e-10)
    for n, a, b in zip(live, got_g, want_g):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-8 * scale, n


def test_served_moments_match_the_program():
    cfg, p0, _ = _setup("lmc6_m1024", 11)
    p0["q_sqrt"] = 0.5 * p0["q_sqrt"]
    config = port.model_config(cfg, "highest")
    X = torch.rand((50, 2), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    ref = svgp.Reference(cfg, "cpu", "float64")
    for t in range(len(cfg["likelihoods"])):
        m, v = tp.make_serving_predictive(port.params(p0), config, t)(X)
        rm, rv = ref.served(p0, X, t)
        assert torch.allclose(rm, m, rtol=1e-9, atol=1e-12), t
        assert torch.allclose(rv, v, rtol=1e-8, atol=1e-12), t


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10), 3.0e-5])
    r = svgp.tf32_round(x)
    assert r[0] == 1.0  # a tie rounds to even
    assert r[1] == 1.0 + 2 ** -9
    assert r[2] == -(1.0 + 2 ** -10)
    assert abs(float(r[3]) - 3.0e-5) <= 3.0e-5 * 2 ** -11
